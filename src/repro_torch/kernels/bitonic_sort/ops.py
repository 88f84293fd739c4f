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

The kernel runs the network in passes.  A pass gives each CTA a chunk of
``CHUNK`` elements: those whose flat indices (row * m + index) agree
outside ``LOG_CHUNK`` chosen bits, the chunk's "owned" bits.  A CTA runs
every stage of a consecutive run of the network whose stride bit it owns,
so :func:`plan` cuts the network into as few runs as 13 owned bits allow
(8 passes at m = 2^18), each owning the flat bits 0-2 as well so that its
loads and stores use whole 32-byte sectors.  Inside a CTA a thread holds
``2**REG_BITS`` elements in registers: those whose local indices differ
in one window of ``REG_BITS`` consecutive local bits.  A stage whose stride
bit lies in the window runs in registers, one whose stride bit is a lane
bit through ``__shfl_xor_sync``; else the chunk moves to another window
through shared memory.  :func:`plan` chooses the windows by dynamic
programming over the run's stages, and encodes each pass as ops the kernel
decodes (:func:`_encode`): runs of stages, each maybe after a move.  The
first pass of every row longer than a chunk is the same, so the kernel is
built with its ops (``FIRST_OPS``) as straight-line code.  The first pass
reads the caller's keys and payload (or makes ``arange(n)``) and writes the
pad itself, into fresh outputs; the caller's tensors are never written.

A CUDA tensor goes through the kernel (int32 or float32 keys) or the call
raises; a CPU (or ``meta``) tensor of any real dtype goes through the plain
version.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from repro_torch.kernels._nvcc import load_library

# LOG_CHUNK, REG_BITS and MAX_OPS go to the kernel as -D flags (DEFINES,
# below); the rest shape the plan.
LOG_CHUNK = 13              # a CTA sorts 2**LOG_CHUNK elements a pass
REG_BITS = 4                # a thread holds 2**REG_BITS of them
MAX_OPS = 32                # ops of one pass the kernel's argument holds
CHUNK = 1 << LOG_CHUNK
THREADS = CHUNK >> REG_BITS
COALESCE_BITS = 3           # flat bits every pass owns: 8 x 4 B = a sector
# the planner's weights, in us for the main shape's 2^20 elements on an
# H100 (PERF.md; `python -m repro_torch.kernels.bitonic_sort.op_costs`
# measures them): decoding an op, a stage's work in registers (times
# "lane_dir" where its direction differs between lanes) or through
# shuffles, a move to another window through shared memory, and one between
# windows of at most WARP_WINDOWS (a warp waits only for itself)
COSTS = {"op": 0.16, "reg": 0.15, "lane_dir": 1.4, "shfl": 0.5,
         "relayout": 0.54, "warp_relayout": 0.39}
WARP_WINDOWS = 5            # windows 0-5 keep a warp's elements its own
EDGE_WINDOW = 5             # the least window a pass loads and stores in
MAX_N = 1 << 30             # the largest padded row the kernel takes
_DTYPES = {torch.int32: 0, torch.float32: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "bitonic_sort.cu"
_load_lock = threading.Lock()
_count_lock = threading.Lock()
_entry = None               # the library's entry point, once loaded

# op encoding, shared with csrc/bitonic_sort.cu: bits 0-1 the kind, bits
# 2-5 its argument (a register bit, a lane bit or a new window), bits 6-7
# how the direction is found, bits 8-13 that rule's argument, bits 14-16 the
# number of stages less one (a run of strides arg, arg - 1, ...); bit 17 set
# moves the chunk to window bits 18-21 before the stages
MOVE_FIRST = 1 << 17
OP_REG, OP_SHFL, OP_RELAYOUT = 0, 1, 2
DIR_ASC, DIR_REG, DIR_THREAD, DIR_CTA = 0, 1, 2, 3


def load():
    """Build the kernel at first use and load it; returns the C entry point
    with its signature set."""
    global _entry
    with _load_lock:
        if _entry is None:
            lib = load_library("bitonic_sort", _SOURCE, defines=DEFINES)
            fn = lib.bitonic_sort_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _entry = fn
        return _entry


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# the kernel's schedule
# ---------------------------------------------------------------------------
def network(log_m: int) -> list:
    """The JAX kernel's stages on rows of 2**log_m: (size bit, stride bit)
    for sizes 2 .. m and strides size/2 .. 1."""
    return [(s, j) for s in range(1, log_m + 1) for j in range(s - 1, -1, -1)]


def passes(log_m: int) -> list:
    """The network cut into passes: [(owned flat bits ascending, stages)].
    Rows of at most CHUNK elements take one pass over flat chunks of
    CHUNK (several rows a chunk); longer rows take a pass for each greedy
    run of stages whose stride bits fit in LOG_CHUNK owned bits."""
    stages = network(log_m)
    if log_m <= LOG_CHUNK:
        return [(list(range(LOG_CHUNK)), stages)]
    out, i = [], 0
    while i < len(stages):
        owned, run = set(range(COALESCE_BITS)), []
        while i < len(stages):
            b = stages[i][1]
            if b not in owned and len(owned) == LOG_CHUNK:
                break
            owned.add(b)
            run.append(stages[i])
            i += 1
        b = 0
        while len(owned) < LOG_CHUNK:       # fill with the lowest bits
            owned.add(b)
            b += 1
        out.append((sorted(owned), run))
    return out


def window_of(j: int, w: int):
    """Where local bit ``j`` lies in the layout of window ``w``: ("reg",
    bit of the register index), ("shfl", lane bit) or ("thread", bit of the
    thread index above the lanes)."""
    if w <= j < w + REG_BITS:
        return "reg", j - w
    t = j if j < w else j - REG_BITS
    return ("shfl" if t < 5 else "thread"), t


def _windows(local: list) -> list:
    """The cheapest window for each stage of ``local`` [(size, size bit or
    None, stride bit)], by dynamic programming; returns [load window, window
    of stage 0, ...].  A stage that continues a run (the same size, the same
    window, the same kind and the next stride) costs no decoding.  The pass
    loads and stores in a window of at least EDGE_WINDOW (5), whose lanes
    then cover local bits 0-4: a warp's load or store is 32 consecutive
    elements where the pass owns flat bits 0-4, whole sectors always."""
    n_w = LOG_CHUNK - REG_BITS + 1
    edge = [0.0 if w >= EDGE_WINDOW else float("inf") for w in range(n_w)]
    cost, back, prev = list(edge), [], None
    for s, js, j in local:
        new, bp = [float("inf")] * n_w, [0] * n_w
        for w2 in range(n_w):
            kind, pos = window_of(j, w2)
            if kind == "thread":
                continue
            stage = COSTS[kind]
            if kind == "reg" and js is not None and \
                    window_of(js, w2)[0] == "shfl":
                stage *= COSTS["lane_dir"]
            run = prev is not None and prev[0] == s and \
                window_of(prev[2], w2) == (kind, pos + 1)
            for w1 in range(n_w):
                if w1 == w2:
                    c = cost[w1] + stage + (0.0 if run else COSTS["op"])
                else:
                    c = cost[w1] + stage + COSTS["op"] + COSTS[
                        "warp_relayout" if max(w1, w2) <= WARP_WINDOWS
                        else "relayout"]
                if c < new[w2]:
                    new[w2], bp[w2] = c, w1
        cost, prev = new, (s, js, j)
        back.append(bp)
    w = min(range(n_w), key=lambda x: cost[x] + edge[x])
    ws = [w]
    for bp in reversed(back):
        w = bp[w]
        ws.append(w)
    return ws[::-1]


def _encode(kind: int, arg: int, dkind: int = DIR_ASC, darg: int = 0,
            count: int = 1) -> int:
    return kind | (arg << 2) | (dkind << 6) | (darg << 8) | (count - 1) << 14


def _runs(ops: list) -> list:
    """Consecutive register stages, or shuffle stages, with one direction
    rule and strides q, q - 1, .. merged into one op, so the kernel decodes
    a run once."""
    out = []
    for op in ops:
        if out and op & 3 != OP_RELAYOUT and out[-1] & 3 == op & 3:
            prev = out[-1]
            count = (prev >> 14) + 1
            if (op >> 6) & 0xFF == (prev >> 6) & 0xFF and \
                    (op >> 2) & 15 == ((prev >> 2) & 15) - count:
                out[-1] = prev + (1 << 14)
                continue
        out.append(op)
    return out


def _fold_moves(ops: list) -> list:
    """Each move folded into the stage op after it (one op to decode)."""
    out = []
    for op in ops:
        if out and out[-1] & 3 == OP_RELAYOUT and op & 3 != OP_RELAYOUT:
            op |= MOVE_FIRST | ((out.pop() >> 2) & 15) << 18
        out.append(op)
    return out


@functools.lru_cache(maxsize=None)
def plan(log_m: int) -> tuple:
    """Each pass as (owned flat bits, load window, ops) for rows of
    2**log_m elements."""
    out = []
    for owned, stages in passes(log_m):
        pos = {b: i for i, b in enumerate(owned)}
        local = [(s, pos.get(s) if s < log_m else None, pos[j])
                 for s, j in stages]
        ws = _windows(local)
        ops, w = [], ws[0]
        for (s, j), (_, js, jl), w2 in zip(stages, local, ws[1:],
                                           strict=True):
            if w2 != w:
                ops.append(_encode(OP_RELAYOUT, w2))
                w = w2
            kind, arg = window_of(jl, w)
            if s >= log_m:                      # size m: all ascending
                d = (DIR_ASC, 0)
            elif js is None:                    # a bit of the CTA's chunk
                d = (DIR_CTA, s)
            else:
                dk, da = window_of(js, w)
                d = (DIR_REG, da) if dk == "reg" else (DIR_THREAD, da)
            ops.append(_encode(OP_REG if kind == "reg" else OP_SHFL, arg, *d))
        ops = _fold_moves(_runs(ops))
        if len(ops) > MAX_OPS:
            raise ValueError(f"a pass of {len(ops)} ops; the kernel holds "
                             f"{MAX_OPS}")
        out.append((tuple(owned), ws[0], tuple(ops)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _plan_array(log_m: int):
    """plan(log_m) flattened for the entry point: [passes, then each pass's
    owned mask (low, high 32 bits), owned bits, load window, op count,
    ops]."""
    flat = [len(plan(log_m))]
    for owned, w0, ops in plan(log_m):
        mask = sum(1 << b for b in owned)
        flat += [mask & 0xFFFFFFFF, mask >> 32, *owned, w0, len(ops), *ops]
    arr = (ctypes.c_uint32 * len(flat))(*flat)
    return arr


# Every row longer than a chunk starts with the same pass; the kernel is
# built with its ops, which it runs as straight-line code.
FIRST_W0, FIRST_OPS = plan(LOG_CHUNK + 1)[0][1:]
DEFINES = {"LOG_CHUNK": LOG_CHUNK, "REG_BITS": REG_BITS, "MAX_OPS": MAX_OPS,
           "FIRST_W0": FIRST_W0,
           "FIRST_OPS": "".join(f"FIRST_OP({op})" for op in FIRST_OPS)}


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def _check(keys: torch.Tensor, payload: torch.Tensor | None) -> int:
    """The wrapper's checks; returns m, n rounded up to a power of two."""
    if not isinstance(keys, torch.Tensor):
        raise TypeError(f"keys must be a torch.Tensor, got {type(keys)}")
    if keys.dim() != 2:
        raise ValueError(f"keys must be 2-D (rows, n), got shape "
                         f"{tuple(keys.shape)}")
    if keys.dtype == torch.bool or keys.is_complex():
        raise ValueError(f"keys must be real numbers, got {keys.dtype}")
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
    m = _next_pow2(keys.shape[1])
    if m > MAX_N:
        raise ValueError(f"n = {keys.shape[1]}; rows are sorted up to "
                         f"{MAX_N} keys")
    return m


def _padded(keys: torch.Tensor, payload: torch.Tensor | None):
    """Fresh contiguous (rows, m) copies of keys and payload, m = n rounded
    up to a power of two, padded with the dtype's max and -1 (what the
    plain version sorts; the kernel pads as it loads)."""
    m = _check(keys, payload)
    rows, n = keys.shape
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
    if not isinstance(keys, torch.Tensor) or keys.device.type in ("cpu",
                                                                  "meta"):
        return bitonic_sort_plain(keys, payload)
    if keys.device.type != "cuda":
        raise ValueError(f"bitonic_sort runs on cuda, cpu or meta, not "
                         f"{keys.device}")
    if keys.dtype not in _DTYPES:
        raise ValueError(f"keys are {keys.dtype}; the kernel takes int32 or "
                         f"float32")
    m = _check(keys, payload)
    rows, n = keys.shape
    if not rows or m < 2:           # nothing to sort: the padded copy
        ko, po, _ = _padded(keys, payload)
        return ko[:, :n], po[:, :n]
    ko = torch.empty((rows, m), dtype=keys.dtype, device=keys.device)
    po = torch.empty((rows, m), dtype=torch.int32, device=keys.device)
    _launch(keys, payload, ko, po)
    return ko[:, :n], po[:, :n]


bitonic_sort.launches = 0     # wrapper calls that launched the kernel


def _launch(keys, payload, ko, po):
    fn = load()
    if keys.stride(1) != 1:
        keys = keys.contiguous()
    if payload is not None and payload.stride(1) != 1:
        payload = payload.contiguous()
    rows, n = keys.shape
    log_m = ko.shape[1].bit_length() - 1
    with torch.cuda.device(ko.device):
        stream = torch.cuda.current_stream(ko.device).cuda_stream
        err = fn(keys.data_ptr(), keys.stride(0),
                 None if payload is None else payload.data_ptr(),
                 0 if payload is None else payload.stride(0),
                 ko.data_ptr(), po.data_ptr(), rows, n, log_m,
                 _DTYPES[keys.dtype], _plan_array(log_m), stream)
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
