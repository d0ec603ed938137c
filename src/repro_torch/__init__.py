"""PyTorch / CUDA port of the lazy-GP hyper-parameter optimizer.

Same layout and names as the JAX package `repro` (the reference): `core`
holds the GP, the acquisition and the BO driver, `kernels` the hand-written
Hopper kernels with their plain PyTorch versions and the dispatch surface.
The port imports neither `jax` nor `repro`; entry points run on the card
(`device="cuda"`) unless the caller asks for the CPU.
"""
__version__ = "0.1.0"
