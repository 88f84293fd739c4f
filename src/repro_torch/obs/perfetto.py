"""Chrome/Perfetto export of a recorded trace.

Produces the JSON object format (``{"traceEvents": [...]}``) both
``chrome://tracing`` and https://ui.perfetto.dev load directly:

* one *process* row per worker, holding that worker's span lanes (``X``
  complete events; concurrent parts get separate ``tid`` lanes, nested
  spans stack on their part's lane; a span's parent index and attributes
  go into its ``args``; the thread executor's tasks share the row
  ``worker thread``),
* a ``scheduler`` process whose lanes carry the dispatch->terminal slice of
  every task (reconstructed from the event stream — present even for
  span-less sim/thread traces) plus instant markers for the pool-level
  events (grow/retire/device_failure/steal/return),
* counter tracks (``C`` events) for every telemetry gauge a worker
  reported — queue depth, RSS, spill bytes, peer-channel cache size,
  ``p2p_fallbacks`` — so a stuck or swapping worker is visible as a flat
  or climbing counter next to its silent span lane.

CLI: ``python -m repro_torch.obs.perfetto run.jsonl [-o trace.json]``.
"""
from __future__ import annotations

import json

_US = 1e6   # trace timestamps are seconds; Chrome wants microseconds

#: pool-level event kinds rendered as instant markers on the scheduler row
INSTANT_KINDS = ("device_failure", "grow", "retire", "steal", "return",
                 "speculate", "retry", "cancel")


def _lanes(intervals):
    """Greedy lane assignment for possibly-overlapping ``(t0, t1, ...)``
    intervals: earliest-start first, each taking the lowest lane free at its
    start — one row per *concurrent* occupant, stable across runs."""
    out = []
    lane_free: list = []             # lane -> time it frees up
    for iv in sorted(intervals, key=lambda x: (x[0], x[1])):
        for i, free_at in enumerate(lane_free):
            if iv[0] >= free_at:
                lane_free[i] = iv[1]
                out.append((i, iv))
                break
        else:
            lane_free.append(iv[1])
            out.append((len(lane_free) - 1, iv))
    return out


def export_perfetto(rec, path=None) -> dict:
    """Convert ``rec`` (a :class:`repro_torch.obs.trace.RecordedTrace`, or any
    object with ``.trace``/``.spans``/``.telemetry`` — a live ``SimReport``
    works too) to the Chrome trace dict; written to ``path`` if given."""
    events = []
    pids: dict[str, int] = {}

    def pid_of(name: str) -> int:
        if name not in pids:
            pids[name] = len(pids)
            events.append({"ph": "M", "pid": pids[name], "name":
                           "process_name", "args": {"name": name}})
        return pids[name]

    sched = pid_of("scheduler")

    # --- scheduler rows: task slices from dispatch -> terminal ------------
    trace = list(getattr(rec, "trace", ()))
    open_at: dict = {}
    slices = []
    for e in trace:
        if e.kind in ("dispatch", "speculate"):
            open_at[e.uid] = e
        elif e.kind in ("done", "fail", "cancel", "retry") and \
                e.uid in open_at:
            d = open_at.pop(e.uid)
            slices.append((d.t, max(e.t, d.t + 1e-9), d, e.kind))
        elif e.kind in INSTANT_KINDS:
            events.append({"ph": "i", "ts": e.t * _US, "pid": sched,
                           "tid": 0, "s": "p", "cat": "scheduler",
                           "name": e.kind,
                           "args": {"task": e.task, "value": e.value}})
    t_end = max((e.t for e in trace), default=0.0)
    for uid, d in open_at.items():   # still running at trace end (crash)
        slices.append((d.t, max(t_end, d.t + 1e-9), d, "truncated"))
    for lane, (t0, t1, d, outcome) in _lanes(slices):
        events.append({"ph": "X", "ts": t0 * _US, "dur": (t1 - t0) * _US,
                       "pid": sched, "tid": lane, "cat": "task",
                       "name": d.task or f"uid{d.uid}",
                       "args": {"uid": d.uid, "ranks": d.ranks,
                                "pipeline": d.pipeline, "outcome": outcome}})

    # --- worker rows: spans, one tid lane per concurrent part -------------
    by_worker: dict[str, list] = {}
    for s in getattr(rec, "spans", ()) or ():
        by_worker.setdefault(s.get("worker", "worker"), []).append(s)
    for wid in sorted(by_worker):
        pid = pid_of(f"worker {wid}")
        # parts sharing a (uid, part) run on one lane; concurrent parts on
        # the worker each get their own
        part_iv: dict = {}
        for s in by_worker[wid]:
            key = (s.get("uid", -1), s.get("part", 0))
            lo, hi = part_iv.get(key, (s["t0"], s["t1"]))
            part_iv[key] = (min(lo, s["t0"]), max(hi, s["t1"]))
        lane_of = {key: lane for lane, (_, _, key) in
                   _lanes([(lo, hi, key) for key, (lo, hi)
                           in part_iv.items()])}
        for s in by_worker[wid]:
            key = (s.get("uid", -1), s.get("part", 0))
            args = {"task": s.get("task", ""), "uid": s.get("uid", -1),
                    "part": s.get("part", 0)}
            if s.get("parent") is not None:
                args["parent"] = s["parent"]
            args.update(s.get("attrs") or {})
            events.append({"ph": "X", "ts": s["t0"] * _US,
                           "dur": max(s["t1"] - s["t0"], 0.0) * _US,
                           "pid": pid, "tid": lane_of[key], "cat": "span",
                           "name": s["kind"], "args": args})

    # --- counter tracks: one per (worker, gauge) ---------------------------
    for rec_t in getattr(rec, "telemetry", ()) or ():
        wid = rec_t.get("worker", "worker")
        pid = pid_of(f"worker {wid}")
        t = rec_t.get("t", 0.0)
        for k, v in rec_t.items():
            if k in ("worker", "t") or not isinstance(v, (int, float)):
                continue
            events.append({"ph": "C", "ts": t * _US, "pid": pid,
                           "name": k, "args": {"value": v}})

    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(out, f)
    return out


def main(argv=None):
    import argparse

    from repro_torch.obs.trace import load_trace

    p = argparse.ArgumentParser(
        description="Export a flight-recorder JSONL trace to "
                    "Chrome/Perfetto trace.json")
    p.add_argument("jsonl", help="recorded trace (REPRO_TRACE output)")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: <jsonl>.trace.json)")
    a = p.parse_args(argv)
    out = a.out or (a.jsonl.rsplit(".jsonl", 1)[0] + ".trace.json")
    doc = export_perfetto(load_trace(a.jsonl), out)
    print(f"{out}: {len(doc['traceEvents'])} events")


if __name__ == "__main__":
    main()
