"""Serving engine (serve/continuous.py, serve/driver.py), rag_sat: the
summed durations (dispatch to done) of the window's ``serve-decode`` tasks
over the decode rounds they ran (the engine's ``serve_decode_steps``
counter, read around each call), in ms a round.  Moves
``served_tokens_per_s``."""
from yardstick.readings import window_tasks


def read(ctx):
    rounds, dur = 0, 0.0
    for t in window_tasks(ctx, "serve-decode"):
        rounds += sum(d[2] for d in ctx["decodes"]
                      if t.start_time <= d[0] and d[1] <= t.end_time)
        dur += t.end_time - t.start_time
    return 1e3 * dur / rounds if rounds else None
