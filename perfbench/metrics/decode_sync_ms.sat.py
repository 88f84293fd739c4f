"""Serving engine (serve/continuous.py), rag_sat: the mean ``decode_sync``
span of the window's ``serve-decode`` tasks, in ms a round: host time
blocked in the round's ``logits.argmax(-1).cpu()``, while the device
finishes the round's kernels and whatever was queued before them.  Moves
``served_tokens_per_s``."""
from yardstick.program_spans import durations, kind, window_spans
from yardstick.readings import mean_ms


def read(ctx):
    return mean_ms(durations(window_spans(ctx, kind("decode_sync"),
                                          "serve-decode")))
