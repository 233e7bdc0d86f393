"""PyTorch/CUDA port of the `vitadapter` JAX package for one NVIDIA H100.

Mirrors the JAX package's layout. Plain tensor code is PyTorch; each TPU
kernel on the ported path is a CUDA kernel written for Hopper
(`ops/csrc/*.cu`), built with nvcc at first use. Entry points run on `cuda`
unless the caller passes `device="cpu"`, where every kernel wrapper uses its
plain PyTorch version. This package imports neither JAX nor `vitadapter`.
"""
