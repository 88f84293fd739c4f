"""PyTorch/CUDA port of the heterogeneous analysis pipeline.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``core``, ``dataframe``, ``kernels``, ``obs``) and imports neither
JAX nor anything of ``repro``.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
