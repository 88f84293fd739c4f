"""Serving engine (serve/continuous.py), rag_sat: the share, in %, of the
window's decode rounds that replayed the captured decode step: the growth
of the engine's ``serve_decode_graph_replays`` counter over that of
``serve_decode_steps``, between the window's first and last telemetry
snapshot of ``ServeDriver``.  None where the engine has no such counter.
Moves ``served_tokens_per_s``."""


def read(ctx):
    snaps = [e.data for e in ctx["trace"]
             if e.kind == "telemetry" and ctx["t0"] <= e.t <= ctx["t_end"]
             and e.data.get("worker") == "serve-driver"]
    if len(snaps) < 2 or "serve_decode_graph_replays" not in snaps[-1]:
        return None
    first, last = snaps[0], snaps[-1]
    rounds = last.get("serve_decode_steps", 0) - \
        first.get("serve_decode_steps", 0)
    if rounds <= 0:
        return None
    replays = last["serve_decode_graph_replays"] - \
        first.get("serve_decode_graph_replays", 0)
    return 100.0 * replays / rounds
