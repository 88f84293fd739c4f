"""Serving engine (serve/continuous.py), rag_sat: the mean
``prefill_issue`` span of the window's ``serve-prefill`` tasks, in ms a
request: host time building the batch and issuing ``api.prefill``, before
the first token's readback.  Moves ``served_tokens_per_s``."""
from yardstick.program_spans import durations, kind, window_spans
from yardstick.readings import mean_ms


def read(ctx):
    return mean_ms(durations(window_spans(ctx, kind("prefill_issue"),
                                          "serve-prefill")))
