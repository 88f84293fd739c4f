"""The Mamba1 selective scan: dt, x (B,S,D); A (D,N); Bm, Cm (B,S,N).

``ssm_scan`` wraps the CUDA kernel in ``csrc/ssm_scan.cu``, which replaces
the Pallas TPU kernel ``src/repro/kernels/ssm_scan/ssm_scan.py::
ssm_scan_kernel`` (wrapper ``ops.py::ssm_scan``).  It computes

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = <h_t, C_t>

with h in f32 and y returned in f32; the caller adds D * x and the gate.
With ``return_state`` it also returns the state after the last step,
(B, D, N) f32: what the TPU kernel leaves in its VMEM scratch at the end of
the grid, and what a prefill hands to decode.

``state_dtype=torch.bfloat16`` is the JAX package's ``ssm_scan_dtype =
"bfloat16"``: the decay and the input are computed in f32 and rounded to
bf16, the state is carried in bf16 (rounded after the product and again
after the sum), C is rounded to bf16, and y is summed in f32.  The kernel
then takes the decay from the same ``expf`` as the plain version's
``torch.exp``, so its state matches the plain version's bit for bit; the
state it returns is the bf16 state, held in f32.  Other dtypes
(float16) are not ported (ROADMAP queue 2 A3).

Unlike the JAX wrapper, which asserts S % chunk == 0 and D % d_block == 0,
this one takes any S and any D: the kernel masks the ragged tails.  Each of
dt, A, Bm, Cm and x may be f32 or bf16 on its own, read as it is (no cast
pass); Bm and Cm are read through their strides, so column slices of the
model's ``x_db`` go in as they are.  Every row must be contiguous in its
last dim.

At the serving shapes, (1, 2048, 8192, 16) and the like, the function is
bound by its exponentials: one exp per (b, s, d, n), B*S*D*N of them,
against reading dt and x and writing y once.

A CUDA tensor goes through the kernel or the call raises; a CPU tensor
goes through :func:`ssm_scan_plain`, the same function in plain PyTorch; a
``meta`` tensor (the serving engines' cache probe, the dry run) gets the
closed form of the kernel's outputs, ``meta`` results of the right shapes,
and launches nothing: the plain version is a Python loop over S, minutes
on ``meta`` at 32k steps, with no matrix product to count.  The kernel's output lies outside
autograd.

Training goes through :class:`SSMScan`, an autograd Function whose forward
is the wrapper (the kernel, on the card) and whose backward differentiates
:func:`ssm_scan_chunked` recomputed from the saved inputs: the JAX
package's chunked associative scan with the C contraction fused
(``src/repro/models/ssm.py::_assoc_scan_fused``), the function its own
Mamba1 training differentiates.  The JAX package has no backward kernel
for the scan either.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch
import torch.utils.checkpoint

from repro_torch.kernels._nvcc import load_library
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

# The kernel is built with these as -D flags, so the checks below use the
# kernel's own numbers.
THREADS = 256               # threads per CTA
LANES = 8                   # threads per channel; y is summed over them
                            # LANES steps at a time
CHUNK = 32                  # time steps staged in shared memory at a time
# One build of the source per class of state size, named by its largest N:
# each thread owns N / LANES of a channel's states.  A call takes the first
# build whose N is large enough, so N <= 16 (falcon-mamba's ssm_state)
# keeps its own build whatever the larger one does; 64 is zamba2's
# ssm_state.
BUILDS = (16, 64)
MAX_STATE = BUILDS[-1]      # largest N
MAX_BATCH = 65535           # the grid's y dimension
# time steps per chunk of ssm_scan_chunked with an f32 state: the JAX
# ModelConfig's default ssm_chunk.  The backward holds one chunk's (B,
# SCAN_CHUNK, D, N) f32 decay, input and state tensors at a time.  A bf16
# state takes the model's cfg.ssm_chunk instead (models/ssm.py::scan_mode).
SCAN_CHUNK = 128
# a dtype's code for the kernel: each input's, and the state's mode
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
_load_lock = threading.Lock()
_count_lock = threading.Lock()
_entries: dict = {}         # a build's largest N -> its loaded entry point


def build_for(n_state: int) -> int:
    """The largest N of the build that takes state size ``n_state``."""
    for max_state in BUILDS:
        if 1 <= n_state <= max_state:
            return max_state
    raise ValueError(f"state size {n_state}; the kernel takes 1..{MAX_STATE}")


def load(n_state: int = 1):
    """Build the kernel for state size ``n_state`` at first use and load it;
    returns the C entry point with its signature set."""
    max_state = build_for(n_state)
    with _load_lock:
        if max_state not in _entries:
            lib = load_library(f"ssm_scan{max_state}", _SOURCE, defines={
                "THREADS": THREADS, "LANES": LANES, "MAX_STATE": max_state,
                "CHUNK": CHUNK})
            fn = lib.ssm_scan_launch
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _entries[max_state] = fn
        return _entries[max_state]


def _check(dt, A, Bm, Cm, x, state_dtype=torch.float32):
    if state_dtype not in _DTYPES:
        raise ValueError(f"state dtype {state_dtype}; the scan carries its "
                         f"state in float32 or bfloat16 (other dtypes: "
                         f"ROADMAP queue 2 A3)")
    named = (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("x", x))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes float32 "
                             f"or bfloat16")
        if t.dim() != (2 if name == "A" else 3):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; dt and x "
                             f"are (B,S,D), A (D,N), Bm and Cm (B,S,N)")
        if t.numel() and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("dt, A, Bm, Cm and x lie on different devices")
    b, s, d = dt.shape
    n = A.shape[1]
    if x.shape != dt.shape or A.shape[0] != d or \
            Bm.shape != (b, s, n) or Cm.shape != (b, s, n):
        raise ValueError(
            f"shapes do not match: dt {tuple(dt.shape)}, x {tuple(x.shape)},"
            f" A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
            f"{tuple(Cm.shape)}")
    build_for(n)
    if b > MAX_BATCH:
        raise ValueError(f"batch {b} > {MAX_BATCH}")


def ssm_scan(dt, A, Bm, Cm, x, *, return_state: bool = False,
             state_dtype: torch.dtype = torch.float32):
    """y (B,S,D) f32, or ``(y, h_last)`` with ``return_state``; the state
    carried in ``state_dtype`` (float32 or bfloat16)."""
    _check(dt, A, Bm, Cm, x, state_dtype)
    dev = dt.device
    if dev.type == "cpu":
        return ssm_scan_plain(dt, A, Bm, Cm, x, return_state=return_state,
                              state_dtype=state_dtype)
    if dev.type == "meta":
        return _empty(dt, A, return_state, "meta")
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda, cpu or meta, not {dev}")
    if dt.numel() == 0:
        y, h = _empty(dt, A, True, dev)
        y.zero_()
        h.zero_()
        return (y, h) if return_state else y
    return _launch(dt, A, Bm, Cm, x, return_state, state_dtype)


ssm_scan.launches = 0     # kernel launches since the last reset


def _empty(dt, A, return_state, device):
    b, s, d = dt.shape
    y = torch.empty((b, s, d), dtype=torch.float32, device=device)
    if not return_state:
        return y
    return y, torch.empty((b, d, A.shape[1]), dtype=torch.float32,
                          device=device)


def _launch(dt, A, Bm, Cm, x, return_state: bool, state_dtype):
    fn = load(A.shape[1])
    b, s, d = dt.shape
    y, h = _empty(dt, A, True, dt.device)
    strides = (ctypes.c_longlong * 9)(
        *dt.stride()[:2], *x.stride()[:2], *Bm.stride()[:2],
        *Cm.stride()[:2], A.stride(0))
    dtypes = (ctypes.c_int * 5)(*(_DTYPES[t.dtype] for t in (dt, A, Bm, Cm,
                                                               x)))
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = fn(dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 x.data_ptr(), y.data_ptr(),
                 h.data_ptr() if return_state else None, strides, dtypes,
                 b, s, d, A.shape[1], _DTYPES[state_dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    with _count_lock:
        ssm_scan.launches += 1
    return (y, h) if return_state else y


def ssm_scan_plain(dt, A, Bm, Cm, x, *, return_state: bool = False,
                   state_dtype: torch.dtype = torch.float32):
    """The kernel's function in plain PyTorch: ``ref.ssm_scan_ref`` behind
    the wrapper's checks.  Used for CPU tensors, by the tests, and on the
    card as the kernel's comparison."""
    _check(dt, A, Bm, Cm, x, state_dtype)
    return ssm_scan_ref(dt, A, Bm, Cm, x, return_state=return_state,
                        state_dtype=state_dtype)


def kernel_order(dt, A, Bm, Cm, x, *, max_state=None, lanes=LANES):
    """The kernel's order of work replayed in plain PyTorch on the inputs'
    device (the CPU in the tests): y (B,S,D) and the final state (B,D,N),
    f32.

    It keeps the kernel's layout: S padded with zero steps to whole chunks
    and D with zero channels to whole CTAs, N with zero states to the
    build's largest N; lane ``l`` of a channel owns states ``j * LANES +
    l``, sums its states' share of y for each of a group of LANES steps,
    and the group goes through the same transpose-reduce, each level
    keeping the half its lane bit names and adding its partner's copy, so
    that lane ``l`` ends with y at step ``t + l`` and writes it there.  The
    state's recurrence is the plain version's, unfused.  ``max_state``
    names the build (by default the one the wrapper takes); ``lanes`` may
    differ from the kernel's LANES."""
    n_max = max_state or build_for(A.shape[1])
    per_lane, channels = n_max // lanes, THREADS // lanes
    b, s, d = dt.shape
    n = A.shape[1]
    sp, dp = -(-s // CHUNK) * CHUNK, -(-d // channels) * channels
    dev = dt.device

    def padded(t, *shape):
        out = torch.zeros(shape, dtype=torch.float32, device=dev)
        out[tuple(slice(0, k) for k in t.shape)] = t.float()
        return out
    dt_, x_ = padded(dt, b, sp, dp), padded(x, b, sp, dp)
    dx = dt_ * x_
    # (.., state) -> (.., j, lane): state j * lanes + lane
    a_ = padded(A, dp, n_max).view(dp, per_lane, lanes)
    bm = padded(Bm, b, sp, n_max).view(b, sp, per_lane, lanes)
    cm = padded(Cm, b, sp, n_max).view(b, sp, per_lane, lanes)
    h = torch.zeros(b, dp, per_lane, lanes, device=dev)
    y = torch.empty(b, sp, dp, device=dev)
    lane = torch.arange(lanes, device=dev)
    for t in range(0, sp, lanes):
        p = torch.empty(b, dp, lanes, lanes, device=dev)  # (.., lane, step)
        for u in range(lanes):
            step = t + u
            decay = torch.exp(dt_[:, step, :, None, None] * a_)
            h = decay * h + dx[:, step, :, None, None] * bm[:, step, None]
            acc = torch.zeros(b, dp, lanes, device=dev)
            for j in range(per_lane):
                acc = acc + h[:, :, j] * cm[:, step, None, j]
            p[..., u] = acc
        m = lanes
        while m > 1:
            o = m // 2
            up = ((lane & o) != 0)[:, None]
            lo, hi = p[..., :o], p[..., o:m]
            send = torch.where(up, lo, hi)
            p = torch.where(up, hi, lo) + send[:, :, lane ^ o]
            m = o
        y[:, t:t + lanes] = p[..., 0].transpose(1, 2)
    return y[:, :s, :d], h.reshape(b, dp, n_max)[:, :d, :n]


# ---------------------------------------------------------------------------
# training: the chunked scan the backward differentiates, and the Function
# ---------------------------------------------------------------------------
def _combine(left, right):
    """The scan's operator on (decay, state) pairs, ``left`` the earlier:
    ``jax.lax.associative_scan``'s ``fn`` in ``_assoc_scan_fused``."""
    (al, bl), (ar, br) = left, right
    return ar * al, ar * bl + br


def _interleave(even, odd):
    """Elements of ``even`` at the even indices of axis 1, ``odd`` at the
    odd ones (``even`` as long as ``odd`` or one longer)."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a, b):
    """The inclusive scan of ``_combine`` over axis 1: the products of the
    decays ``a`` and the states from a zero start.  A port of
    ``jax.lax.associative_scan``'s recursion (pairs reduced, the half
    scanned, the evens filled in from the odds), so the products happen in
    the JAX package's order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        odd_prev = (odd[0][:, :-1], odd[1][:, :-1])
    else:
        odd_prev = odd
    even = _combine(odd_prev, (a[:, 2::2], b[:, 2::2]))
    return tuple(_interleave(torch.cat([e0[:, :1], e], dim=1), o)
                 for e0, e, o in zip((a, b), even, odd))


def _scan_chunk(h, dt, A, Bm, Cm, x, state_dtype):
    """One chunk of :func:`ssm_scan_chunked` from state ``h`` (B,D,N): the
    JAX package's ``_mamba1_ssm_inputs`` decay and input for the chunk in
    f32 (cast to ``state_dtype``, as ``mamba1_apply`` casts them, with C),
    its ``chunk_body`` scan in that dtype, and C contracted at once in
    f32.  Returns y (B,c,D) f32 and the chunk's last state."""
    dt, A, Bm, Cm, x = (t.float() for t in (dt, A, Bm, Cm, x))
    a = torch.exp(dt[..., None] * A)                          # (B,c,D,N)
    b = (dt * x)[..., None] * Bm[:, :, None, :]
    if state_dtype != torch.float32:
        a, b, Cm = a.to(state_dtype), b.to(state_dtype), Cm.to(state_dtype)
    pa, pb = associative_scan(a, b)
    h_all = pb + pa * h[:, None]
    return (torch.einsum("bscn,bsn->bsc", h_all.float(), Cm.float()),
            h_all[:, -1])


def jax_chunk(s: int, chunk: int) -> int:
    """The JAX package's chunk length for S steps: the largest divisor of
    S no larger than ``chunk`` (``_assoc_scan_chunked``)."""
    chunk = max(min(chunk, s), 1)
    while s % chunk:
        chunk -= 1
    return chunk


def ssm_scan_chunked(dt, A, Bm, Cm, x, *, chunk: int = SCAN_CHUNK,
                     state_dtype: torch.dtype = torch.float32):
    """y (B,S,D) f32: the function of :func:`ssm_scan` as the JAX package's
    Mamba1 training computes it, chunk after chunk, each by an associative
    scan.  With an f32 state the chunks are ``chunk`` steps long, the last
    may be shorter; with a bf16 state the chunk is shrunk to the largest
    divisor of S, as the JAX package shrinks ``cfg.ssm_chunk``, because
    there the chunks' bounds decide where the state is rounded: this then
    gives the JAX ``_assoc_scan_chunked``'s states bit for bit.  Where
    gradients are recorded each chunk runs under
    ``torch.utils.checkpoint``: the forward keeps only each chunk's
    starting state, and the backward rebuilds one chunk's (B, chunk, D, N)
    tensors at a time."""
    _check(dt, A, Bm, Cm, x, state_dtype)
    b, s, d = dt.shape
    if state_dtype != torch.float32:
        chunk = jax_chunk(s, chunk)
    h = torch.zeros((b, d, A.shape[1]), dtype=state_dtype, device=dt.device)
    ys = []
    for t in range(0, s, chunk):
        args = (h, dt[:, t:t + chunk], A, Bm[:, t:t + chunk],
                Cm[:, t:t + chunk], x[:, t:t + chunk], state_dtype)
        if torch.is_grad_enabled():
            y, h = torch.utils.checkpoint.checkpoint(_scan_chunk, *args,
                                                     use_reentrant=False)
        else:
            y, h = _scan_chunk(*args)
        ys.append(y)
    if not ys:
        return torch.zeros((b, s, d), dtype=torch.float32, device=dt.device)
    return torch.cat(ys, dim=1)


class SSMScan(torch.autograd.Function):
    """``apply(dt, A, Bm, Cm, x[, state_dtype, chunk])`` -> y (B,S,D) f32:
    forward through :func:`ssm_scan` (the kernel on the card, the
    sequential plain version on the CPU); backward through autograd of
    :func:`ssm_scan_chunked` at the same state dtype and ``chunk``,
    recomputed from the saved inputs, so the gradients are bit for bit
    those of ``ssm_scan_chunked`` (at bf16: the JAX package's gradients
    through its bf16 chunked scan)."""

    @staticmethod
    def forward(ctx, dt, A, Bm, Cm, x, state_dtype=torch.float32,
                chunk=SCAN_CHUNK):
        ctx.save_for_backward(dt, A, Bm, Cm, x)
        ctx.state_dtype, ctx.chunk = state_dtype, chunk
        return ssm_scan(dt, A, Bm, Cm, x, state_dtype=state_dtype)

    @staticmethod
    def backward(ctx, grad_y):
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y = ssm_scan_chunked(*ins, chunk=ctx.chunk,
                                 state_dtype=ctx.state_dtype)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, grad_y))
        return (*(next(grads) if n else None for n in need), None, None)
