"""Run cells as the check runs them, one process a run, one after another,
and keep each run's result line and compared numbers.

    python3 perfbench/tools/runs.py --workload <name> --seconds 40 \
        --seeds 1 2 3 4 5 6 --sets 2 [--trace-seeds 7 8 9] \
        [--out runs.jsonl]

``--sets 2`` runs the seeds twice over (the same seeds in both sets), then
each ``--trace-seeds`` seed once with ``--trace 1``.  Prints, for each set,
each end-to-end metric's median and its spread: the distance between the
first and the third quartile (``statistics.quantiles(values, n=4)``) as a
share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = str(Path(__file__).resolve().parents[1] / "run.py")


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t = time.perf_counter()
    p = subprocess.run([sys.executable, RUN, "--workload", workload,
                        "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)],
                       capture_output=True, text=True)
    rec = {"workload": workload, "seed": seed, "trace": trace,
           "rc": p.returncode, "wall_s": time.perf_counter() - t}
    try:
        rec["result"] = json.loads(p.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        rec["stdout_tail"] = p.stdout[-2000:]
    rec["stderr_tail"] = p.stderr[-1500:]
    return rec


def spread(values: list) -> tuple:
    med = statistics.median(values)
    q = statistics.quantiles(values, n=4)
    return med, (q[2] - q[0]) / med if med else float("nan")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", help="a JSONL file to append each line to")
    args = ap.parse_args()
    sets = []
    plan = [(s, k, 0) for k in range(args.sets) for s in args.seeds] + \
        [(s, -1, 1) for s in args.trace_seeds]
    for seed, k, trace in plan:
        rec = one(args.workload, seed, args.seconds, trace)
        rec["set"] = k
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        res = rec.get("result", {})
        print(json.dumps({"seed": seed, "set": k, "trace": trace,
                          "rc": rec["rc"], "wall_s": round(rec["wall_s"], 1),
                          "correct": res.get("correct"),
                          "metrics": {m: v["value"] for m, v in
                                      res.get("metrics", {}).items()},
                          "checks": res.get("checks"),
                          "peak": res.get("device", {}).get(
                              "memory_peak_bytes"),
                          "busy_s": res.get("device", {}).get("busy_s"),
                          "window_s": res.get("device", {}).get(
                              "window_s")}), flush=True)
        if rec["rc"] != 0:
            print(rec.get("stderr_tail", ""), flush=True)
        if trace == 0:
            while len(sets) <= k:
                sets.append([])
            sets[k].append(res.get("metrics", {}))
    for k, runs in enumerate(sets):
        names = sorted({m for r in runs for m in r})
        for m in names:
            vals = [r[m]["value"] for r in runs if m in r]
            if len(vals) >= 2:
                med, sp = spread(vals)
                print(f"set {k} {m}: median {med!r} spread {sp!r} "
                      f"values {vals}", flush=True)


if __name__ == "__main__":
    main()
