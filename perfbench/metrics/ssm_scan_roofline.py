"""Kernel layer (kernels/ssm_scan), rag_sat: the share of its roofline the
scan kernel reached in the traced sub-window, in %.  Each launch wholly
inside it is matched to the prefill whose host span holds its start, which
gives its length S; its bound is the larger of its float32 operations at
67 TFLOP/s and its bytes at 3.35 TB/s (``counts.ssm_scan_bound_s``: dt and
y in float32, x, B and C in the model's dtype, the final state returned).
Moves ``served_tokens_per_s``."""
from yardstick.readings import containing


def read(ctx):
    w = ctx.get("device_window")
    if w is None:
        return None
    c, cfg = ctx["counts"], ctx["cfg"]
    pre = [(s, e, a["prompt"]) for _, s, e, a in ctx["spans"].named("prefill")]
    md = cfg["torch_dtype"]
    bound = t = 0.0
    for _, s, e in w.matching("ssm_scan"):
        rec = containing(pre, s)
        if rec is None:
            continue
        bound += c.ssm_scan_bound_s(1, rec[2], cfg["intermediate_size"],
                                    cfg["state_size"], dt="float32", x=md,
                                    bc=md, y="float32", state=True)
        t += (e - s) / 1e9
    return 100.0 * bound / t if t > 0 else None
