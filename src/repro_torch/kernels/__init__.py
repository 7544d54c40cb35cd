"""Hand-written CUDA kernels, each beside its plain PyTorch version.

Each kernel is a subpackage with:
  csrc/     -- CUDA C++ sources for sm_90a (plain C entry points)
  kernel.py -- builds the sources with nvcc and binds them with ctypes
  ops.py    -- the wrappers: checks, launch counters, dispatch by device
  ref.py    -- the plain PyTorch versions (CPU path and oracles)
"""
