"""Kernel layer (models/moe.py's dropless expert layer), jamba2-mini.longdoc:
the share of their roofline that prefill's grouped expert products reached
in the traced sub-window, in %.

``moe.grouped_mm`` runs each of an expert layer's three products (``wg``,
``wi``, ``wo``) as one ``torch._grouped_mm``, which torch 2.11 on the card
runs as a CUTLASS grouped kernel, ``cutlass::device_kernel<...GemmUniversal<
GroupProblemShape<...>, ...KernelPtrArrayTmaWarpSpecialized<schedule>...>>``.
Its tile schedule follows the product's rows: ``Cooperative`` (128x256
tiles) for a prefill's thousands of rows, ``Pingpong`` (64x128) for a
decode round's 32 (``max_batch`` x top-2).  The products matched here are
the device operations whose names hold both ``GroupProblemShape`` and
``Cooperative``.

A prefill span (the benchmark's, around the engine's ``prefill_request``)
ends with the first token's readback, so the prefill's own products ran on
the card inside it; decode replays run inside it too, on the same stream,
and are the ``Pingpong`` ones.  Only prefills whose span lies wholly inside
the sub-window are read, and each must hold exactly its 3 x 16 products:
a count that differs means the schedule no longer tells prefill from
decode (another torch), and the reader raises rather than read a share of
the wrong kernels.  A prefill's bound is its products' count times the
larger of one product's FLOPs, 2 d f a pair over its held pairs a layer
(the engine's ``serve_moe_pairs_held`` for the request, ``ctx["moe_pairs"]``,
over the 16 expert layers), at 989 TFLOP/s, and the held experts' weight
bytes of one product at 3.35 TB/s (``counts_jamba.expert_product_bound_s``).
The mean pairs a layer give a bound no larger than the layers' own pairs
would, so a share over 100 % is a fault, and raises too.  The reading is
the prefills' bounds over their products' device time.  None where the
program counts no held pairs or no prefill lies inside the sub-window.
Moves ``served_tokens_per_s``."""
from yardstick import counts_jamba

MOE_KERNELS = ("GroupProblemShape", "Cooperative")
PRODUCTS_A_LAYER = 3


def read(ctx):
    w = ctx.get("device_window")
    pairs = ctx.get("moe_pairs") or {}
    if w is None or not pairs:
        return None
    n_moe = counts_jamba.sizes(ctx["cfg"])["moe_layers"]
    mine = [(s, e) for name, s, e in w.matching(MOE_KERNELS[0])
            if MOE_KERNELS[1] in name]
    bound = t = 0.0
    for _, s0, e0, a in ctx["spans"].named("prefill"):
        if s0 < w.t0_ns or e0 > w.t1_ns or not pairs.get(a["uid"]):
            continue
        ran = [(s, e) for s, e in mine if s0 <= s and e <= e0]
        if len(ran) != PRODUCTS_A_LAYER * n_moe:
            raise ValueError(
                f"request {a['uid']}: {len(ran)} grouped {MOE_KERNELS[1]} "
                f"products inside its prefill, not "
                f"{PRODUCTS_A_LAYER * n_moe}")
        b = len(ran) * counts_jamba.expert_product_bound_s(
            ctx["cfg"], pairs[a["uid"]] / n_moe)
        took = sum(e - s for s, e in ran) / 1e9
        if b > took:
            raise ValueError(f"request {a['uid']}: its expert products "
                             f"ran in {took:.6f} s, under their bound "
                             f"{b:.6f} s")
        bound += b
        t += took
    return 100.0 * bound / t if t > 0 else None
