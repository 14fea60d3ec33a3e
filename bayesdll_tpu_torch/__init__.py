"""PyTorch/CUDA port of bayesdll_tpu.

The JAX package `bayesdll_tpu` is the reference; this package reproduces
its training paths in PyTorch, slice by slice, with every TPU (Pallas)
kernel replaced by a kernel written by hand for NVIDIA Hopper (`csrc/`).
It imports nothing of `bayesdll_tpu` or JAX.

Every entry point runs on the device named by `Config.device` ("cuda" by
default); pass `device="cpu"` to run the plain PyTorch versions of the
kernels on the CPU.
"""
