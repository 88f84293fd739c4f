"""Kernel layer (kernels/flash_attention), jamba2-mini.longdoc: the share
of its roofline the attention kernel reached in the traced sub-window, in
%.  Each launch wholly inside it (a device operation whose name holds
``flash_attention``: ``flash_attention_wgmma_kernel`` in bf16) is matched
to the prefill whose host span holds its start, which gives its length
S; its bound is 4 hd H S (S + 1) / 2 FLOPs (the causal products' pairs) at
989 TFLOP/s (``counts_jamba.flash_attention_bound_s``).  Decode attends
outside the kernel.  Moves ``served_tokens_per_s``."""
from yardstick import counts_jamba
from yardstick.readings import containing


def read(ctx):
    w = ctx.get("device_window")
    if w is None:
        return None
    pre = [(s, e, a["prompt"]) for _, s, e, a in ctx["spans"].named("prefill")]
    bound = t = 0.0
    for _, s, e in w.matching("flash_attention"):
        rec = containing(pre, s)
        if rec is None:
            continue
        bound += counts_jamba.flash_attention_bound_s(ctx["cfg"], rec[2])
        t += (e - s) / 1e9
    return 100.0 * bound / t if t > 0 else None
