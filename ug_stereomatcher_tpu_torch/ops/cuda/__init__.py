"""Hand-written Hopper kernels of the mode-1 path and their wrappers.

Each module holds one kernel's wrapper and its plain PyTorch version.  A
wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors.  Nothing here builds or loads the kernel
library at import time: ``_build.library()`` does it at the first launch.
"""
