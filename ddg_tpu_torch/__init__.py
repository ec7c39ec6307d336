"""ddg_tpu_torch — the PyTorch/CUDA port of `ddg_tpu` for NVIDIA Hopper.

A second package beside the JAX one, held against it module by module.
Plain tensor code is PyTorch; every Pallas TPU kernel on a ported path is
a CUDA C++ kernel for `sm_90a` under `csrc/`, built with `nvcc` at first
use (`ops/_build.py`) and bound with `ctypes`. Each kernel's wrapper runs
its plain PyTorch version for CPU tensors and launches the kernel (or
raises) for CUDA tensors.

The package imports `torch` and numpy only: never `jax`, `flax` or any
module of `ddg_tpu`.
"""

__version__ = "0.1.0"
