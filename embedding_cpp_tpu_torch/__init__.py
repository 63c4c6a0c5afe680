"""PyTorch/CUDA port of the embedding engine.

A package beside the JAX package `embedding_cpp_tpu`, which stays the
reference it is held against; it imports nothing of it.  Kernels are
hand-written CUDA C++ for Hopper (`csrc/`), built with nvcc at first use.
Entry points run on the GPU unless the caller passes `device="cpu"`.
"""
from .runtime.engine import Engine

__all__ = ["Engine"]
