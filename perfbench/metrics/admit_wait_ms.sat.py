"""Serving engine (serve/driver.py, serve/continuous.py), rag_sat: the mean
wait, in ms, of an admission between the end of its prefill and its
``insert`` into a slot: the growth of the engine's ``serve_admit_wait_us``
counter over that of ``serve_admitted``, between the window's first and
last telemetry snapshot of ``ServeDriver``.  Moves
``served_tokens_per_s``."""


def read(ctx):
    snaps = [e.data for e in ctx["trace"]
             if e.kind == "telemetry" and ctx["t0"] <= e.t <= ctx["t_end"]
             and e.data.get("worker") == "serve-driver"]
    if len(snaps) < 2 or "serve_admit_wait_us" not in snaps[-1]:
        return None
    first, last = snaps[0], snaps[-1]
    n = last.get("serve_admitted", 0) - first.get("serve_admitted", 0)
    if n <= 0:
        return None
    waited = last["serve_admit_wait_us"] - first.get("serve_admit_wait_us", 0)
    return waited / n / 1e3
