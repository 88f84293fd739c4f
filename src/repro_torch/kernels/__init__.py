"""Kernels written by hand for Hopper, one directory each: the CUDA source
under ``csrc/``, ``ops.py`` (the wrapper, its launch count and the plain
PyTorch version) and ``ref.py`` (the oracle)."""
