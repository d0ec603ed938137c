"""Hand-written CUDA kernels for the lazy-GP hot spots, with their plain
PyTorch versions (counterpart of `repro.kernels`).

  * `matern.py` — Matérn-2.5 covariance build (`csrc/matern.cu`)
  * `mixed.py`  — mixed-space (Matérn x categorical) covariance build
                  (`csrc/mixed.cu`)
  * `trsv.py`   — blocked forward/backward substitution (`csrc/trsv.cu`)
  * `chol.py`   — blocked right-looking Cholesky (`csrc/chol.cu`)
  * `acq.py`    — fused EI value + gradient, float and mixed form
                  (`csrc/acq.cu`)
  * `ops.py`    — the dispatch surface, including the padded-state ops
  * `ref.py`    — the plain versions the CPU runs and the card is held to
  * `_build.py` — nvcc build at first use and the ctypes loader

A CUDA tensor goes to the kernel, a CPU tensor to the plain version.  Each
kernel module counts its launches in `LAUNCHES`; `acq` counts its mixed
form apart, in `LAUNCHES_MIXED`, and `trsv` its general solve apart from
L X = I, in `LAUNCHES_GENERAL`.
"""
from repro_torch.kernels import acq, chol, matern, mixed, ops, ref, trsv

KERNEL_MODULES = (matern, mixed, trsv, chol, acq)

__all__ = ["KERNEL_MODULES", "acq", "chol", "matern", "mixed", "ops", "ref",
           "trsv"]
