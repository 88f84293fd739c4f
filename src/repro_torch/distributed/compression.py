"""Gradient compression with error feedback for the data-parallel mean, the
JAX package's ``src/repro/distributed/compression.py``, over logical ranks.

int8 block quantization: per-block absmax scales, values quantized to int8.
The all-reduce then moves int16 accumulators (safe for group sums up to
256 ranks) — 2 bytes/elem instead of 4 (f32 grads) — and the residual
(quantization error) is fed back into the next step's gradient (error
feedback, Seide et al. style).

Where the JAX function runs inside ``shard_map`` on one rank's array and
calls ``pmax``/``psum`` over a named axis, the port's takes every rank's
tensor as a list in rank order and runs the collectives of
``dataframe/comm.py`` over their devices.  The arithmetic is the JAX
package's, in its order: the error is ``xe - local_deq`` at the rank's
own scale; the shared scale is the ``pmax`` of the scales; ``local_deq``
(not ``xe``) is re-quantised to int16 at that scale; the int16 values are
summed and the sum times the shared scale divided by n.  ``torch.round``
rounds half to even, as ``jnp.round`` does.  The JAX train step does not
read ``ParallelConfig.grad_compression``, so the port's does not either.
"""
from __future__ import annotations

import torch

from repro_torch.core.communicator import torch_device
from repro_torch.dataframe import comm as C

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    n = x.numel()
    pad = (-n) % BLOCK
    flat = x.reshape(-1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, n, pad


def quantize_int8(x: torch.Tensor):
    """x any-shape float -> (q int8 (nblk, BLOCK), scales (nblk,), meta)."""
    flat, n, _ = _pad_to_block(x.to(torch.float32))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127,
                    127).to(torch.int8)
    return q, scale, (tuple(x.shape), n)


def dequantize_int8(q, scale, meta) -> torch.Tensor:
    shape, n = meta
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]
    return flat.reshape(shape)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat, _, _ = _pad_to_block(x)
    return flat.reshape(-1, BLOCK)


def _unblock(blocks: torch.Tensor, meta) -> torch.Tensor:
    shape, n = meta
    return blocks.reshape(-1)[:n].reshape(shape)


def compressed_psum_mean(xs: list, devices: list, errors=None):
    """Mean over ranks of ``xs`` (rank r's tensor on ``devices[r]``, a
    rank handle or a device) with
    int8 quantization and error feedback; ``errors``: each rank's error
    from the previous call, or None.  Returns ``(means, new_errors)``,
    lists in rank order; every rank's mean is the same.

    The wire format is int16 (quantized values summed exactly across <= 256
    ranks) plus one f32 scale per block of 256: about 2 bytes/element
    against 4 for f32."""
    devices = [torch_device(d) for d in devices]
    n = C.axis_size(devices)
    errors = errors if errors is not None else [None] * n
    local, scales, new_errors = [], [], []
    for x, e in zip(xs, errors):
        xe = x + (e if e is not None else 0.0)
        q, scale, meta = quantize_int8(xe)
        deq = dequantize_int8(q, scale, meta)
        new_errors.append(xe - deq)
        local.append(deq)
        scales.append(scale)
    # shared scale: the max scale across ranks, so integer sums commute
    gscales = C.pmax(scales, devices)
    requant = [torch.clamp(torch.round(_blocks(d) / g[:, None]), -127,
                           127).to(torch.int16)
               for d, g in zip(local, gscales)]
    summed = C.psum(requant, devices)
    means = [_unblock(s.to(torch.float32) * g[:, None] / n, meta)
             for s, g in zip(summed, gscales)]
    return means, new_errors


def wire_bytes(x: torch.Tensor) -> int:
    """The bytes one rank's tensor puts on the wire compressed: int16
    values of the padded blocks and one f32 scale a block."""
    nblk = -(-x.numel() // BLOCK)
    return nblk * BLOCK * 2 + nblk * 4


def tree_compressed_psum_mean(trees: list, devices: list, errors=None):
    """:func:`compressed_psum_mean` leaf by leaf over each rank's tree (a
    nested dict); threads each leaf's error.  Returns ``(means,
    new_errors)``, one tree a rank each."""
    def walk(nodes, errs):
        if isinstance(nodes[0], dict):
            out = {k: walk([t[k] for t in nodes],
                           None if errs is None else [e[k] for e in errs])
                   for k in nodes[0]}
            return ([{k: v[0][r] for k, v in out.items()}
                     for r in range(len(nodes))],
                    [{k: v[1][r] for k, v in out.items()}
                     for r in range(len(nodes))])
        return compressed_psum_mean(nodes, devices, errs)
    return walk(trees, errors)
