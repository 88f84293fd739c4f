"""Per-row ascending sort of (rows, n) keys carrying an int32 payload.

``bitonic_sort`` wraps the CUDA kernel in ``csrc/bitonic_sort.cu``, which
replaces the Pallas TPU kernel
``src/repro/kernels/bitonic_sort/bitonic_sort.py::bitonic_sort_kernel``
(wrapper ``ops.py::bitonic_sort``).  The contract is the JAX wrapper's: the
payload defaults to ``arange(n)`` in every row; n is padded to the next
power of two with the key dtype's largest finite value (payload -1), and
the result is trimmed back to n.  The network is not stable: keys equal
``ref.sort_ref``'s, and the payload is a permutation that regathers them.

The kernel and :func:`bitonic_sort_plain` run the JAX kernel's network,
stage for stage, with its compare-exchange predicates, so their keys and
payloads are bit-identical to the JAX kernel's, ties, signed zeros and NaN
included.  That reproduces three edges of the reference: a +inf key in a
padded row comes back as the pad value with payload -1 (the pad sorts
below it and the trim keeps the pad); a row holding NaN comes back
unsorted; an INT32_MAX key ties with the pad, so a trimmed payload may
hold -1.

A CUDA tensor goes through the kernel (int32 or float32 keys) or the call
raises; a CPU tensor of any real dtype goes through the plain version.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels._nvcc import load_library

# The kernel is built with these as -D flags.
CHUNK = 8192                # elements of a row one CTA sorts in shared memory
THREADS = 512               # threads a CTA
MAX_N = 1 << 30             # the largest padded row the kernel takes
_DTYPES = {torch.int32: 0, torch.float32: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "bitonic_sort.cu"
_load_lock = threading.Lock()
_count_lock = threading.Lock()
_entry = None               # the library's entry point, once loaded


def load():
    """Build the kernel at first use and load it; returns the C entry point
    with its signature set."""
    global _entry
    with _load_lock:
        if _entry is None:
            lib = load_library("bitonic_sort", _SOURCE, defines={
                "CHUNK": CHUNK, "THREADS": THREADS})
            fn = lib.bitonic_sort_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _entry = fn
        return _entry


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _padded(keys: torch.Tensor, payload: torch.Tensor | None):
    """Fresh contiguous (rows, m) copies of keys and payload, m = n rounded
    up to a power of two, padded with the dtype's max and -1."""
    if not isinstance(keys, torch.Tensor):
        raise TypeError(f"keys must be a torch.Tensor, got {type(keys)}")
    if keys.dim() != 2:
        raise ValueError(f"keys must be 2-D (rows, n), got shape "
                         f"{tuple(keys.shape)}")
    if keys.dtype == torch.bool or keys.is_complex():
        raise ValueError(f"keys must be real numbers, got {keys.dtype}")
    rows, n = keys.shape
    if payload is not None:
        if not isinstance(payload, torch.Tensor):
            raise TypeError(f"payload must be a torch.Tensor, got "
                            f"{type(payload)}")
        if payload.shape != keys.shape or payload.dtype != torch.int32:
            raise ValueError(f"payload must be int32 of keys' shape "
                             f"{tuple(keys.shape)}, got {payload.dtype} of "
                             f"{tuple(payload.shape)}")
        if payload.device != keys.device:
            raise ValueError("keys and payload lie on different devices")
    m = _next_pow2(n)
    if m > MAX_N:
        raise ValueError(f"n = {n}; rows are sorted up to {MAX_N} keys")
    info = torch.finfo if keys.is_floating_point() else torch.iinfo
    ko = torch.full((rows, m), info(keys.dtype).max, dtype=keys.dtype,
                    device=keys.device)
    po = torch.full((rows, m), -1, dtype=torch.int32, device=keys.device)
    ko[:, :n] = keys
    po[:, :n] = (torch.arange(n, dtype=torch.int32, device=keys.device)
                 if payload is None else payload)
    return ko, po, n


def bitonic_sort(keys: torch.Tensor, payload: torch.Tensor | None = None):
    """keys (rows, n); optional payload (rows, n) int32.  Returns
    (sorted_keys, payload_perm), ascending per row, trimmed to n."""
    if not isinstance(keys, torch.Tensor) or keys.device.type == "cpu":
        return bitonic_sort_plain(keys, payload)
    if keys.device.type != "cuda":
        raise ValueError(f"bitonic_sort runs on cuda or cpu, not "
                         f"{keys.device}")
    if keys.dtype not in _DTYPES:
        raise ValueError(f"keys are {keys.dtype}; the kernel takes int32 or "
                         f"float32")
    ko, po, n = _padded(keys, payload)
    rows, m = ko.shape
    if rows and m > 1:
        _launch(ko, po)
    return ko[:, :n], po[:, :n]


bitonic_sort.launches = 0     # wrapper calls that launched the kernel


def _launch(ko: torch.Tensor, po: torch.Tensor):
    fn = load()
    rows, m = ko.shape
    with torch.cuda.device(ko.device):
        stream = torch.cuda.current_stream(ko.device).cuda_stream
        err = fn(ko.data_ptr(), po.data_ptr(), rows, m, _DTYPES[ko.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"bitonic_sort kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        bitonic_sort.launches += 1


def _network(keys: torch.Tensor, payload: torch.Tensor):
    """The JAX kernel's network on (rows, m) rows, m a power of two: for
    each size 2, 4, .., m and stride size/2, .., 1, every element compares
    with element ``idx ^ stride`` and keeps itself or takes its partner by
    ``_compare_exchange``'s predicates."""
    m = keys.shape[-1]
    idx = torch.arange(m, device=keys.device)
    size = 2
    while size <= m:
        stride = size // 2
        while stride >= 1:
            partner = idx ^ stride
            pk, pp = keys[:, partner], payload[:, partner]
            is_low = idx < partner
            ascending = (idx & size) == 0
            keep_self = torch.where(
                is_low,
                torch.where(ascending, keys <= pk, keys >= pk),
                torch.where(ascending, keys >= pk, keys <= pk))
            keys = torch.where(keep_self, keys, pk)
            payload = torch.where(keep_self, payload, pp)
            stride //= 2
        size *= 2
    return keys, payload


def bitonic_sort_plain(keys: torch.Tensor,
                       payload: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch: the same padding, the same
    network stage by stage, the same trim.  Used for CPU tensors (of any
    real dtype), by the tests, and on the card as the kernel's
    comparison."""
    ko, po, n = _padded(keys, payload)
    ks, ps = _network(ko, po)
    return ks[:, :n], ps[:, :n]
