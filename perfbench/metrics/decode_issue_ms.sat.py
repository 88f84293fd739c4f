"""Serving engine (serve/continuous.py), rag_sat: the mean ``decode_issue``
span of the window's ``serve-decode`` tasks, in ms a round: host time from
a decode round's start to its readback, issuing the step's kernels.  Moves
``served_tokens_per_s``."""
from yardstick.program_spans import durations, kind, window_spans
from yardstick.readings import mean_ms


def read(ctx):
    return mean_ms(durations(window_spans(ctx, kind("decode_issue"),
                                          "serve-decode")))
