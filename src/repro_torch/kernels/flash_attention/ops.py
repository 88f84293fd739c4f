"""Causal GQA attention in the model layout: q (B,Sq,H,hd), k/v (B,Sk,K,hd).

``flash_attention`` wraps the CUDA kernel in ``csrc/flash_attention.cu``,
which replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel``
(wrapper ``ops.py::flash_attention``).  At the serving shapes the function
is bound by arithmetic: 4 * hd FLOPs per unmasked (row, col) pair per head
(two products) against reading q, k, v and writing o once.  bf16 and f16
inputs run the products on the tensor cores (``wgmma``, f32 accumulators;
one template on the element type, P rounded to it as the TPU kernel rounds
p to ``v.dtype``), fed by TMA copies into a ring of ``KV_STAGES`` kv
tiles; f32 inputs run them in f32 on the CUDA cores, which keeps the
result within 2e-5 of the plain version.  The kernel reads the model
layout through its strides (TMA tensor maps of 2-byte elements), so the
wrapper neither transposes nor pads: the ragged Sq / Sk tail is masked
inside the kernel.

The causal mask is the TPU kernel's, ``cols <= rows``, top-left aligned.
The oracle (``ref.attention_ref``) aligns the suffixes (offset Sk - Sq);
the two agree only when Sq == Sk, so a causal call with Sq != Sk raises.

A CUDA tensor goes through the kernel or the call raises; a CPU or
``meta`` tensor goes through :func:`flash_attention_plain`, the same
function in plain PyTorch.

Training goes through :class:`FlashAttention`, an autograd Function whose
forward is the wrapper (the kernel, on the card) and whose backward
recomputes the attention with the plain function it is given and returns
``torch.autograd.grad`` of it.  That plain function is the model's
``attend_full`` or ``attend_blockwise``, whichever the JAX train step
differentiates at the sequence length; the JAX package has no backward
kernel either.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels._nvcc import load_library
from repro_torch.kernels.flash_attention.ref import attention_ref

# The kernel is built with these as -D flags, so the checks below use the
# kernel's own numbers.
BLOCK_Q = 64                # f32: query rows per CTA
BLOCK_K = 64                # f32: key rows per shared-memory tile
WG_BLOCK_Q = 128            # bf16, f16: query rows per CTA (64 a warpgroup)
WG_BLOCK_K = 128            # bf16, f16: key rows per TMA tile
KV_STAGES = 2               # bf16, f16: kv tiles in flight in shared memory
MAX_HEAD_DIM = 128
# 112 (zamba2's shared attention) runs on the hd-128 tiles in bf16 and f16
HEAD_DIMS = tuple(d for d in (16, 32, 64, 112, 128) if d <= MAX_HEAD_DIM)
DEFINES = {"BLOCK_Q": BLOCK_Q, "BLOCK_K": BLOCK_K, "WG_BLOCK_Q": WG_BLOCK_Q,
           "WG_BLOCK_K": WG_BLOCK_K, "KV_STAGES": KV_STAGES,
           "MAX_HEAD_DIM": MAX_HEAD_DIM}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_load_lock = threading.Lock()
_count_lock = threading.Lock()
_entry = None               # the library's entry point, once loaded


def load():
    """Build the kernel at first use and load it; returns the C entry point
    with its signature set."""
    global _entry
    with _load_lock:
        if _entry is None:
            lib = load_library("flash_attention", _SOURCE, defines=DEFINES)
            _entry = entry_point(lib)
        return _entry


def entry_point(lib):
    """The library's C entry point with its signature set."""
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, causal: bool):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, heads, hd), got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes "
                             f"float32, bfloat16 or float16")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k, v lie on different devices")
    b, sq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}; the kernel takes {HEAD_DIMS}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if q.dtype != torch.float32 and any(
            t.data_ptr() % 16 or any(st % 8 for n, st in
                                     zip(t.shape[:3], t.stride()[:3])
                                     if n > 1)
            for t in (q, k, v)):
        raise ValueError(f"{q.dtype} rows of q, k and v must start 16-byte "
                         f"aligned: the kernel copies them with TMA")
    if causal and sq != k.shape[1]:
        raise ValueError(f"causal attention needs Sq == Sk (the kernel's "
                         f"mask is top-left aligned), got {sq} and "
                         f"{k.shape[1]}")


def flash_attention(q, k, v, *, causal: bool = True):
    """Softmax attention with scale hd**-0.5; kv head of query head h is
    h // (H // K).  Returns (B, Sq, H, hd) in q's dtype."""
    _check(q, k, v, causal)
    dev = q.device
    if dev.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not "
                         f"{dev}")
    if q.shape[0] == 0 or q.shape[1] == 0 or q.shape[2] == 0:
        return torch.empty_like(q)
    return _launch(q, k, v, causal)


flash_attention.launches = 0     # kernel launches since the last reset


def _launch(q, k, v, causal: bool):
    out = call_entry(load(), q, k, v, causal)
    with _count_lock:
        flash_attention.launches += 1
    return out


def call_entry(fn, q, k, v, causal: bool):
    """Run the C entry point ``fn`` (this source's, or another build's with
    the same signature) on checked CUDA inputs; returns the output."""
    b, sq, h, hd = q.shape
    _, sk, kh, _ = k.shape
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, _DTYPES[q.dtype], b, h, kh, sq, sk, hd,
                 int(causal), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """The kernel's function in plain PyTorch: ``ref.attention_ref`` behind
    the wrapper's checks, in the model layout.  Used for CPU tensors, by the
    tests, and on the card as the kernel's comparison."""
    _check(q, k, v, causal)
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """``apply(q, k, v, causal, plain)``: forward through
    :func:`flash_attention`; backward through autograd of ``plain(q, k, v,
    causal=causal)`` recomputed from the saved inputs, so the gradients
    are bit for bit those of ``plain``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, plain):
        ctx.causal, ctx.plain = causal, plain
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*qkv, causal=ctx.causal)
            wrt = [t for t in qkv if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad_out))
        return (*(next(grads) if n else None for n in need), None, None)
