"""Kernel layer (kernels/ssm_scan), jamba2-mini.longdoc: the share of its
roofline the scan kernel, the one falcon-mamba-7b runs, reached in the
traced sub-window at this mix's lengths, in %.  Each launch wholly inside
it is matched to the prefill whose host span holds its start, which gives
its length S; its bound is the larger of its float32 operations at 67
TFLOP/s and its bytes at 3.35 TB/s, over d_inner = mamba_expand x
hidden_size channels (``counts_jamba.ssm_scan_bound``).  Decode steps the
state outside the kernel.  Moves ``served_tokens_per_s``."""
from yardstick import counts_jamba
from yardstick.readings import containing


def read(ctx):
    w = ctx.get("device_window")
    if w is None:
        return None
    pre = [(s, e, a["prompt"]) for _, s, e, a in ctx["spans"].named("prefill")]
    bound = t = 0.0
    for _, s, e in w.matching("ssm_scan"):
        rec = containing(pre, s)
        if rec is None:
            continue
        bound += counts_jamba.ssm_scan_bound(ctx["cfg"], rec[2])
        t += (e - s) / 1e9
    return 100.0 * bound / t if t > 0 else None
