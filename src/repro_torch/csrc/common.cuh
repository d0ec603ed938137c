// Shared by every kernel library of the port.
//
// Each .cu file under csrc/ builds into its own shared library with a plain
// C interface (nvcc -shared, loaded with ctypes by kernels/_build.py).  A C
// entry launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.  Everything is float32 with float32 accumulation, like the Pallas
// kernels it replaces; the libraries are never built with --use_fast_math,
// so expf / erff / sqrtf keep their IEEE-accurate forms.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kSqrt5 = 2.23606797749979f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

}  // namespace repro

REPRO_EXPORT const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
