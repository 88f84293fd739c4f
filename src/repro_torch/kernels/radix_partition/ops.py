"""Bucket-major stable destinations for a partition or shuffle.

``radix_partition`` wraps the CUDA kernel in ``csrc/radix_partition.cu``,
which replaces the Pallas TPU kernel
``src/repro/kernels/radix_partition/radix_partition.py::radix_partition_kernel``
(wrapper ``ops.py::radix_partition``).  The function is bound by memory
traffic: it must read the (n,) int32 buckets and write the (n,) int32
destinations, 8 bytes a row, against almost no arithmetic.  The kernel is
two launches that read the buckets twice (12 bytes a row): a histogram
pass that counts each CTA's chunk of tiles, and a ranking pass in which
each CTA starts its chunk from the earlier chunks' counts (up to
SMALL_BUCKETS buckets), or chains the tiles' counts with a decoupled
look-back (more buckets; its scratch is zeroed by one memset on the
caller's stream).

A CUDA tensor goes through the kernel or the call raises; a CPU or
``meta`` tensor goes through :func:`radix_partition_plain`, the same
function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels._nvcc import load_library
from repro_torch.kernels.radix_partition.ref import destinations_ref

# The kernel is built with these as -D flags, so the scratch sized here and
# the checks below use the kernel's own numbers.
MAX_BUCKETS = 1024          # the largest bucket count
SMALL_BUCKETS = 16          # up to this many buckets, per-thread counters
TILE = 4096                 # rows a CTA ranks
THREADS = 256               # threads a CTA
_SOURCE = Path(__file__).resolve().parent / "csrc" / "radix_partition.cu"
_load_lock = threading.Lock()
_count_lock = threading.Lock()
_entry = None               # the library's entry point, once loaded


def load():
    """Build the kernel at first use and load it; returns the C entry point
    with its signature set."""
    global _entry
    with _load_lock:
        if _entry is None:
            lib = load_library("radix_partition", _SOURCE, defines={
                "TILE": TILE, "THREADS": THREADS,
                "SMALL_BUCKETS": SMALL_BUCKETS, "MAX_BUCKETS": MAX_BUCKETS})
            fn = lib.radix_partition_launch
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _entry = fn
        return _entry


def _check(buckets: torch.Tensor, n_buckets: int):
    if not isinstance(buckets, torch.Tensor):
        raise TypeError(f"buckets must be a torch.Tensor, got {type(buckets)}")
    if buckets.dtype != torch.int32 or buckets.dim() != 1:
        raise ValueError(f"buckets must be a 1-D int32 tensor, got "
                         f"{buckets.dtype} of shape {tuple(buckets.shape)}")
    if not buckets.is_contiguous():
        raise ValueError("buckets must be contiguous")
    if buckets.shape[0] >= 2 ** 31:
        raise ValueError(f"n = {buckets.shape[0]} rows; the kernel takes "
                         f"n < 2**31")
    if not 1 <= n_buckets <= MAX_BUCKETS:
        raise ValueError(f"n_buckets = {n_buckets}; the kernel takes "
                         f"1 <= n_buckets <= {MAX_BUCKETS}")


def radix_partition(buckets: torch.Tensor, n_buckets: int):
    """buckets (n,) int32 in [0, n_buckets) -> (dest (n,) int32,
    hist (n_buckets,) int32): row i belongs at position dest[i] of the
    bucket-major layout, rows of one bucket in their original order.  On
    the card a row whose id lies outside [0, n_buckets) gets dest -1 and
    is not counted; the plain version rejects such ids."""
    _check(buckets, n_buckets)
    n = buckets.shape[0]
    dev = buckets.device
    if n_buckets == 1:
        # the single-bucket partition is the identity; like the JAX
        # wrapper, answer without launching the kernel
        return (torch.arange(n, dtype=torch.int32, device=dev),
                torch.full((1,), n, dtype=torch.int32, device=dev))
    if dev.type in ("cpu", "meta"):
        return radix_partition_plain(buckets, n_buckets)
    if dev.type != "cuda":
        raise ValueError(f"radix_partition runs on cuda, cpu or meta, not "
                         f"{dev}")
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros(n_buckets, dtype=torch.int32, device=dev))
    return _launch(buckets, n_buckets)


radix_partition.launches = 0     # kernel launches since the last reset


def scratch_words(n: int, n_buckets: int) -> int:
    """int32 words of the kernel's scratch, enough for either way it ranks:
    up to SMALL_BUCKETS buckets it keeps one count per (bucket, CTA), at
    most one CTA a tile; above, two words for each (tile, bucket) look-back
    word, the histogram's sums and a ticket.  A view may start up to 3 rows
    past a 16-byte boundary, which may add a tile."""
    return 2 * n_buckets * -(-(n + 3) // TILE) + n_buckets + 1


def _launch(buckets: torch.Tensor, n_buckets: int):
    fn = load()
    n = buckets.shape[0]
    dev = buckets.device
    ptr = buckets.data_ptr()
    if ptr % 4:
        raise ValueError("buckets must be 4-byte aligned")
    # dest lies at the same address modulo 16 as buckets, so the kernel's
    # 16-byte groups of rows line up in both (a view such as b[1:] starts
    # 4, 8 or 12 bytes past a boundary); hist shares its allocation
    buf = torch.empty(n + 3 + n_buckets, dtype=torch.int32, device=dev)
    shift = (ptr - buf.data_ptr()) % 16 // 4
    dest, hist = buf[shift:shift + n], buf[n + 3:]
    scratch = torch.empty(scratch_words(n, n_buckets), dtype=torch.int32,
                          device=dev)
    args = (ptr, dest.data_ptr(), hist.data_ptr(), scratch.data_ptr(), n,
            n_buckets, torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"radix_partition kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        radix_partition.launches += 1
    return dest, hist


def radix_partition_plain(buckets: torch.Tensor, n_buckets: int):
    """The kernel's function in plain PyTorch: ``ref.destinations_ref``
    behind the wrapper's checks and a range check of the bucket ids.  Used
    for CPU tensors, by the tests, and on the card as the kernel's
    comparison.  ``meta`` ids hold no values to range-check."""
    _check(buckets, n_buckets)
    if buckets.numel() and not buckets.is_meta and not (
            0 <= int(buckets.min()) and int(buckets.max()) < n_buckets):
        raise ValueError(f"bucket ids must lie in [0, {n_buckets})")
    return destinations_ref(buckets, n_buckets)
