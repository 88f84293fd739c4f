"""Mixture-of-Experts FFN with capacity-based dispatch, the JAX package's
``src/repro/models/moe.py`` on one device.

Dense routing (f32 logits, softmax, top-k, gates renormalised) → a stable
sort gives each (token, expert) pair its position in the expert's group →
one scatter of the tokens into a flat ``(E·C + 1, d)`` buffer, whose last
row takes every pair at a position ``>= C`` (dropped) → three batched
expert products (``torch.bmm``: ``ecd,edf->ecf`` twice, ``ecf,efd->ecd``)
→ one gather of each pair's expert output from the same flat index (the
dropped pairs read a zero row) → a sum over each token's k pairs, weighted
by its gates.  No loop over experts, and no atomics: ``token_of_pair`` is
``repeat(arange(T), k)``, so each token's pairs are contiguous and the
combine is a ``(T, k, d)`` sum.

Reference behaviours kept exactly:

* top-k ties go to the lower expert index, as ``jax.lax.top_k`` breaks
  them (``torch.topk`` does not): the experts are chosen by a stable
  descending sort;
* the capacity C is computed from the number of tokens in the call, so a
  batched prefill can drop pairs that a single-request prefill keeps;
* a dropped pair contributes 0; the shared experts' sigmoid gate is
  computed in f32 and cast.

Inside a data rank's pass whose model group splits the experts over
``model`` (``wg``'s spec puts ``model`` on E, as the JAX constraint on
the expert buffer does where E divides; ``distributed/context.py``),
``moe_ffn`` routes the data rank's tokens once, at one capacity, and runs
``_experts`` once a model rank on its experts' slots (the other experts'
pairs go to its drop row); the partial outputs are summed in rank order.
Where E does not divide (qwen2-moe's 60 experts on 16 ranks) the experts
stay whole.  The shared experts' MLP is split as any MLP
(``layers.mlp_apply``).

Jamba (``models/jamba.py``) calls :func:`moe_ffn_dropless`, the
published routing of a dropless model: the gates are left as the softmax
gave them, no pair is ever dropped, and the layer holds the experts
``[cfg.first_expert, cfg.first_expert + E_held)`` of the router's
``router.shape[1]``; the pairs routed elsewhere add nothing.

``moe_ffn_shardmap`` is the JAX package's local-expert EP, which it
writes per model rank under ``shard_map``: each data shard's tokens route
on their own, at the capacity of their own count; each model rank owns
``E // tp`` experts and runs only the pairs routed to them (the others go
to the drop row); the partial outputs are summed over the model ranks in
rank order (``dataframe/comm.py::psum``), and the shared experts are
added after.  ``moe_ffn`` switches to it under ``axes_ctx(mesh,
"shardmap")``, as the JAX one does.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from repro_torch.dataframe import comm
from repro_torch.distributed.context import (current_mesh, current_moe_impl,
                                             is_split, mesh_sizes, model_sum,
                                             over_model, twins)
from repro_torch.models.layers import (dense, dense_init, mlp_apply,
                                       mlp_init)


def expert_init(gen: torch.Generator, n: int, shape, dtype) -> torch.Tensor:
    """An ``(n,) + shape`` stack drawn as ``dense_init`` draws it (normal
    times 1/sqrt(fan_in), fan_in every dim but the last of the stacked
    leaf), one expert's slice at a time: the f32 temporary is one
    expert's, not the whole stack's."""
    out = torch.empty((n, *shape), dtype=dtype, device=gen.device)
    if out.device.type == "meta":
        return out
    std = 1.0 / math.sqrt(n * math.prod(shape[:-1]))
    for e in range(n):
        out[e] = (torch.randn(shape, generator=gen, dtype=torch.float32,
                              device=gen.device) * std).to(dtype)
    return out


def moe_init(gen: torch.Generator, cfg, dtype) -> dict:
    """``router`` (d, E) and ``shared_gate`` (d, 1) stay float32 in a bf16
    model; ``wg``/``wi`` (E, d, f), ``wo`` (E, f, d); ``shared`` is a
    SwiGLU MLP of width ``n_shared_experts * d_ff``."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init(gen, (d, E), torch.float32),
         "wg": expert_init(gen, E, (d, f), dtype),
         "wi": expert_init(gen, E, (d, f), dtype),
         "wo": expert_init(gen, E, (f, d), dtype)}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.n_shared_experts * f, dtype)
        p["shared_gate"] = dense_init(gen, (d, 1), torch.float32)
    return p


def capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(p, x, cfg, renormalize: bool = True):
    """x (T, d) -> (expert_idx (T, k) int64, gates (T, k) f32).  Ties
    between gates go to the lower expert index; the k gates are scaled to
    sum to 1 unless ``renormalize`` is False."""
    logits = dense(x.float(), p["router"])
    gates_all = torch.softmax(logits, dim=-1)
    idx = torch.sort(gates_all, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.top_k]
    gates = gates_all.gather(-1, idx)
    if renormalize:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return idx, gates


def dispatch_indices(expert_idx, n_experts: int, cap: int):
    """Flattened (T*k,) expert assignment -> (expert, position) pairs.
    Positions >= cap are overflow (dropped by the scatter, 0 in the
    combine).  Stable within expert (sorted order)."""
    flat_e = expert_idx.reshape(-1)                       # (T*k,)
    sorted_e, order = torch.sort(flat_e, stable=True)     # grouped by e
    start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, dtype=sorted_e.dtype,
                               device=sorted_e.device), side="left")
    pos_sorted = torch.arange(flat_e.shape[0], device=flat_e.device) \
        - start[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    return flat_e, pos


def _shared(p, xt, out, cfg):
    if not cfg.n_shared_experts:
        return out
    sg = torch.sigmoid(dense(xt.float(), p["shared_gate"]))
    return out + mlp_apply(p["shared"], xt) * sg.to(out.dtype)


def _experts(xt, slot, gates, wg, wi, wo, cap):
    """Each pair's expert output, weighted by its gate and summed over each
    token's k pairs: pair i (token i // k) goes to row ``slot[i]`` of a
    flat ``(E·cap + 1, d)`` buffer for the E experts of ``wg``/``wi``/``wo``,
    whose last row takes the dropped pairs and reads back zero."""
    T, d = xt.shape
    k, E = gates.shape[1], wg.shape[0]
    # scatter: pair i carries token i // k (its k copies side by side)
    pairs_x = xt[:, None].expand(T, k, d).reshape(T * k, d)
    ebuf = xt.new_zeros((E * cap + 1, d)).index_copy(0, slot, pairs_x)
    ebuf = ebuf[:E * cap].view(E, cap, d)

    g = F.silu(torch.bmm(ebuf, wg))
    u = torch.bmm(ebuf, wi)
    eout = torch.bmm(g * u, wo).reshape(E * cap, d)

    # combine: gather each pair's expert output (dropped -> the zero row),
    # weight by its gate, sum each token's k pairs
    pair_out = torch.cat([eout, eout.new_zeros((1, d))]).index_select(0, slot)
    return (pair_out.view(T, k, d)
            * gates[..., None].to(pair_out.dtype)).sum(dim=1)


def moe_ffn(p, x, cfg):
    """x (..., d) -> (..., d).  Flattens all leading dims into tokens."""
    mesh = current_mesh()
    if current_moe_impl() == "shardmap" and mesh is not None:
        return moe_ffn_shardmap(p, x, cfg, mesh)
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    E = cfg.n_experts
    C = capacity(xt.shape[0], cfg)

    idx, gates = route(p, xt, cfg)                        # (T, k)
    e_of_pair, pos_of_pair = dispatch_indices(idx, E, C)  # (T*k,)
    if is_split(p["wg"]):
        out = model_sum(over_model(lambda m, q: _rank_experts(
            xt, e_of_pair, pos_of_pair, gates, q, m, C), twins(p)))
        return _shared(p, xt, out, cfg).reshape(*lead, d)
    # each pair's row of the flat (E·C + 1, d) buffer; E·C takes the drops
    slot = torch.where(pos_of_pair < C, e_of_pair * C + pos_of_pair, E * C)
    out = _experts(xt, slot, gates, p["wg"], p["wi"], p["wo"], C)
    return _shared(p, xt, out, cfg).reshape(*lead, d)


def _rank_experts(xt, e_of_pair, pos_of_pair, gates, q, m: int, cap: int):
    """Model rank m's partial output: its experts ``[m·el, (m+1)·el)``
    (``q``: its slice of the layer) on the pairs routed to them within the
    capacity; every other pair goes to its drop row."""
    el = q["wg"].shape[0]
    local = e_of_pair - m * el
    mine = (local >= 0) & (local < el) & (pos_of_pair < cap)
    slot = torch.where(mine, local * cap + pos_of_pair, el * cap)
    return _experts(xt, slot, gates, q["wg"], q["wi"], q["wo"], cap)


def moe_ffn_shardmap(p, x, cfg, mesh):
    """Local-expert EP over ``mesh``'s ranks (a ``Communicator``): the
    tokens split into one contiguous shard per data rank (the ``pod`` and
    ``data`` axes), each routed at ``capacity(t_loc)``; model rank m runs
    experts ``[m·el, (m+1)·el)``, ``el = E // tp``, on views of the
    weights, foreign experts' pairs dropped; one ``psum`` over the model
    ranks combines the partial outputs.  x (..., d) -> (..., d)."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    E = cfg.n_experts
    sizes = mesh_sizes(mesh)
    dpn = 1
    for a in ("pod", "data"):
        dpn *= sizes.get(a, 1)
    tpn = sizes.get("model", 1)
    if E % tpn or xt.shape[0] % dpn:
        raise ValueError(f"{E} experts and {xt.shape[0]} tokens on "
                         f"{dpn} data x {tpn} model ranks: shard_map needs "
                         f"both to divide")
    el = E // tpn
    t_loc = xt.shape[0] // dpn
    cap = capacity(t_loc, cfg)
    # rank m's experts: its own slice where a model group split them
    own = twins(p) if is_split(p["wg"]) else None
    outs = []
    for xl in xt.split(t_loc):
        idx, gates = route(p, xl, cfg)
        e_flat = idx.reshape(-1)
        partial = []
        for m in range(tpn):
            lo = m * el
            # global expert ids -> local slots; foreign experts -> slot el
            local_e = torch.where((e_flat >= lo) & (e_flat < lo + el),
                                  e_flat - lo, el)
            _, pos = dispatch_indices(local_e.reshape(-1, 1), el + 1, cap)
            slot = torch.where((local_e < el) & (pos < cap),
                               local_e * cap + pos, el * cap)
            w = own[m] if own else {k: p[k][lo:lo + el]
                                    for k in ("wg", "wi", "wo")}
            partial.append(_experts(xl, slot, gates, w["wg"], w["wi"],
                                    w["wo"], cap))
        outs.append(comm.psum(partial, [xl.device])[0])
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return _shared(p, xt, out, cfg).reshape(*lead, d)


def moe_ffn_dense_oracle(p, x, cfg, keep=None):
    """O(T·E·d·f) oracle: run every expert on every token, combine by gates
    (no capacity drops).  ``keep`` (T, k) bool, if given, drops the pairs
    it marks False (the pairs ``moe_ffn`` drops at the call's capacity),
    which the JAX oracle cannot express."""
    lead = x.shape[:-1]
    xt = x.reshape(-1, x.shape[-1])
    idx, gates = route(p, xt, cfg)
    g = F.silu(torch.einsum("td,edf->tef", xt, p["wg"]))
    u = torch.einsum("td,edf->tef", xt, p["wi"])
    alle = torch.einsum("tef,efd->ted", g * u, p["wo"])       # (T, E, d)
    sel = torch.gather(alle, 1, idx[..., None].expand(-1, -1,
                                                       alle.shape[-1]))
    w = gates[..., None].to(sel.dtype)
    if keep is not None:
        w = w * keep[..., None].to(sel.dtype)
    out = (sel * w).sum(dim=1)
    return _shared(p, xt, out, cfg).reshape(*lead, -1)


# ----------------------------------------------------------------------------
# dropless dispatch over the experts a layer holds (Jamba)
# ----------------------------------------------------------------------------
class HeldPairs:
    """The device count of the (token, expert) pairs that the dropless
    layers computed while it was open (:func:`held_pairs`): ``total`` is
    an int64 device scalar, or None where no such layer ran."""

    def __init__(self):
        self.total = None

    def add(self, n):
        self.total = n if self.total is None else self.total + n


class _Counting(threading.local):
    held = None


_counting = _Counting()


@contextmanager
def held_pairs():
    """Count, on the device and without a readback, the pairs that the
    dropless expert layers issued on this thread inside the block route to
    their held experts (the serving engine's prefill)."""
    prev, _counting.held = _counting.held, HeldPairs()
    try:
        yield _counting.held
    finally:
        _counting.held = prev


def grouped_mm(x, w, ends):
    """Rows ``[ends[e-1], ends[e])`` of ``x`` (P, d) times ``w[e]`` (E, d,
    f), for each e; the rows from ``ends[-1]`` on are left undefined and
    cost nothing.  ``ends`` (E,) int32 stays on the device.  One
    ``torch._grouped_mm`` where it runs its grouped kernel (bf16 on the
    card) and on the CPU; else (a float32 model on the card, or its
    ``meta`` twin) a masked product per expert over all the rows, which
    needs no host copy of the group ends either."""
    if x.device.type == "cpu" or x.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w, offs=ends)
    row = torch.arange(x.shape[0], device=x.device)
    seg = torch.searchsorted(ends, row.to(ends.dtype), right=True)
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    for e in range(w.shape[0]):
        out = torch.where((seg == e)[:, None], x @ w[e], out)
    return out


def moe_ffn_dropless(p, x, cfg):
    """The expert layer of a dropless model over the experts it holds:
    x (..., d) -> (..., d).

    Every token is routed over all ``router.shape[1]`` experts (f32
    softmax, top-k with ties to the lower index, the gates not
    renormalised); the layer holds ``E = wg.shape[0]`` of
    them from ``cfg.first_expert`` on.  A stable sort groups the T·k pairs
    by held expert, those of the other experts last; each held expert's
    products run over its own rows only (:func:`grouped_mm`, the group
    ends computed on the device), so nothing is padded to a capacity and
    nothing is dropped.  Each pair's output goes back to its place, is
    weighted by its gate and summed over the token's k pairs; the pairs of
    experts held elsewhere give exactly 0.  Nothing is read back to the
    host."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    T, k = xt.shape[0], cfg.top_k
    E = p["wg"].shape[0]
    idx, gates = route(p, xt, cfg, renormalize=False)       # (T, k)
    local = idx.reshape(-1) - cfg.first_expert
    mine = (local >= 0) & (local < E)                       # (T*k,)
    key = torch.where(mine, local, E)
    order = torch.sort(key, stable=True).indices
    ends = torch.searchsorted(
        key[order], torch.arange(1, E + 1, dtype=key.dtype,
                                 device=key.device)).to(torch.int32)
    if _counting.held is not None:
        _counting.held.add(ends[-1].long())
    rows = xt.index_select(0, order // k)                   # (T*k, d)
    a = grouped_mm(rows, p["wg"], ends)
    b = grouped_mm(rows, p["wi"], ends)
    if torch.is_grad_enabled():
        h = F.silu(a) * b
    else:
        h = F.silu(a, inplace=True).mul_(b)
    del a, b
    sorted_out = grouped_mm(h, p["wo"], ends)
    del h
    pair_out = torch.index_copy(torch.empty_like(sorted_out), 0, order,
                                sorted_out).view(T, k, d)
    out = torch.where(mine.view(T, k, 1),
                      pair_out * gates[..., None].to(pair_out.dtype),
                      pair_out.new_zeros(())).sum(dim=1)
    return out.reshape(*lead, d)
