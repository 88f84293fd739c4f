"""Model step (models/jamba.py and the layers it composes),
jamba2-mini.longdoc: the model FLOPs of every request finished in the
window over the window's seconds, as a share of 989 TFLOP/s, in %.  A
request's FLOPs are its prefill and its decode steps counted from the
configuration's shapes (``counts_jamba.request_flops``), its expert
products from the pairs its prefill routed to the held experts (the
engine's ``serve_moe_pairs_held``, a request at a time,
``ctx["moe_pairs"]``), and as many a token in its decode steps.  None
where the program counts no such pairs.  Moves ``served_tokens_per_s``."""
from yardstick import counts_jamba


def read(ctx):
    done, pairs = ctx["finished_in_window"], ctx.get("moe_pairs") or {}
    uids = {id(r): u for u, r in ctx["requests"].items()}
    recs = [(r, pairs.get(uids[id(r)])) for r in done]
    if not recs or any(p is None or p <= 0 for _, p in recs):
        return None
    flops = sum(counts_jamba.request_flops(ctx["cfg"], len(r["prompt"]),
                                           r["answer"], p)
                for r, p in recs)
    return 100.0 * flops / ((ctx["t_end"] - ctx["t0"])
                            * counts_jamba.H100_BF16_FLOPS)
