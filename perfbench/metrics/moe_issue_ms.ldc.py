"""Model step (models/jamba.py, models/moe.py), jamba2-mini.longdoc: the
mean host time, in ms, that a prefill spends issuing its expert layers:
the ``moe`` spans of the window's ``serve-prefill`` tasks, summed, over
the number of their ``prefill_issue`` spans.  None where the program
records no ``moe`` span.  Moves ``served_tokens_per_s``."""
from yardstick.program_spans import durations, kind, window_spans


def read(ctx):
    moe = window_spans(ctx, kind("moe"), "serve-prefill")
    prefills = window_spans(ctx, kind("prefill_issue"), "serve-prefill")
    if not moe or not prefills:
        return None
    return sum(durations(moe)) / len(prefills) * 1e3
