"""Model step (models/ssm_lm.py, models/ssm.py, models/layers.py), rag_sat:
the model FLOPs of every request finished in the window (its prefill and
its decode steps, counted from the configuration's shapes by
``counts.mamba1_request_flops``) over the window's seconds, as a share of
989 TFLOP/s, in %.  Moves ``served_tokens_per_s``."""


def read(ctx):
    done = ctx["finished_in_window"]
    if not done:
        return None
    c, cfg = ctx["counts"], ctx["cfg"]
    flops = sum(c.mamba1_request_flops(cfg, len(r["prompt"]), r["answer"])
                for r in done)
    return 100.0 * flops / ((ctx["t_end"] - ctx["t0"]) * c.H100_BF16_FLOPS)
