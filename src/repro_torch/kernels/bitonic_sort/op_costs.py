"""Measure what one op of the bitonic_sort kernel costs on the card: the
weights of ``ops.COSTS``, which the planner's dynamic program uses.

    PYTHONPATH=src python -m repro_torch.kernels.bitonic_sort.op_costs \\
        [--shape 4,262144] [--ops 24] [--reps 20]

At the shape's int32 rows, every pass after the first (the first is compiled
in and takes no ops) runs ``--ops`` copies of one op instead of its plan,
and the wrapper's time (a CUDA graph of one call, so that the host's
launches do not set it; CUDA events, median) is held against the same
passes with no ops at all: the difference over (passes x ops) is one op's
cost in us for all the shape's elements.  The kinds: a register stage
whose direction is one flag for the CTA, the same with a direction that
differs between lanes, a run of REG_BITS register stages (its cost over
REG_BITS is a stage's work, "stage"; a single stage less that is the
decoding, "decode"), a shuffle stage, a move through shared memory, and a
move between a warp's own windows.  These sorts do not sort, and nothing
is checked.  Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.kernels.bitonic_sort import ops


def _median_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        times.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def _ops_of(kind: str, count: int, w0: int, top: int) -> tuple:
    """``count`` copies of one op for a pass that loads in window ``w0``
    and so stores in it (moves go there and back), and the number of moves
    between other windows that a warp's moves need around them; ``top`` is
    a flat bit above the row, a direction flag for the whole CTA."""
    enc, rb = ops._encode, ops.REG_BITS
    if kind == "reg":
        return (enc(ops.OP_REG, 0, ops.DIR_CTA, top),) * count, 0
    if kind == "reg_lanes":
        return (enc(ops.OP_REG, 0, ops.DIR_THREAD, 0),) * count, 0
    if kind == "reg_run":
        return (enc(ops.OP_REG, rb - 1, ops.DIR_CTA, top, rb),) * (
            count // rb), 0
    if kind == "shfl":
        return (enc(ops.OP_SHFL, 0, ops.DIR_CTA, top),) * count, 0
    if kind == "move":
        far = 3 if w0 > ops.WARP_WINDOWS else ops.LOG_CHUNK - rb
        return (enc(ops.OP_RELAYOUT, far), enc(ops.OP_RELAYOUT, w0)) * (
            count // 2), 0
    home = w0 if w0 <= ops.WARP_WINDOWS else 0      # kind == "warp_move"
    pair = (enc(ops.OP_RELAYOUT, 3 if home != 3 else 0),
            enc(ops.OP_RELAYOUT, home))
    if home == w0:
        return pair * (count // 2), 0
    return ((enc(ops.OP_RELAYOUT, home),) + pair * (count // 2)
            + (enc(ops.OP_RELAYOUT, w0),)), 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="4,262144", help="rows,n")
    ap.add_argument("--ops", type=int, default=24,
                    help="a multiple of REG_BITS and of 2, at most "
                    "MAX_OPS - 2")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("op_costs: no CUDA device is visible")
    if args.ops % (2 * ops.REG_BITS) or args.ops + 2 > ops.MAX_OPS:
        raise SystemExit(f"op_costs: --ops {args.ops} is not a multiple of "
                         f"{2 * ops.REG_BITS} of at most {ops.MAX_OPS - 2}")
    rows, n = (int(x) for x in args.shape.split(","))
    log_m = max(n - 1, 1).bit_length()
    if log_m <= ops.LOG_CHUNK:
        raise SystemExit(f"op_costs: rows of {n} take one pass; the ops "
                         f"are timed in the passes after the first")
    keys = torch.randint(0, 1 << 30, (rows, n), dtype=torch.int32,
                         device="cuda")
    plan, real = ops.plan, ops.plan(log_m)
    kinds = ("none", "reg", "reg_lanes", "reg_run", "shfl", "move",
             "warp_move")
    ms, extra_moves = {}, 0
    try:
        for kind in kinds:
            passes = [real[0]]
            for owned, w0, _ in real[1:]:
                body, extra = ((), 0) if kind == "none" else _ops_of(
                    kind, args.ops, w0, log_m)
                passes.append((owned, w0, body))
                extra_moves += extra if kind == "warp_move" else 0
            ops.plan = lambda lm, fake=tuple(passes): (
                fake if lm == log_m else plan(lm))
            ops._plan_array.cache_clear()
            ops.bitonic_sort(keys)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                ops.bitonic_sort(keys)
            ms[kind] = _median_ms(graph.replay, args.reps)
    finally:
        ops.plan = plan
        ops._plan_array.cache_clear()
    later = len(real) - 1
    us = {kind: (ms[kind] - ms["none"]) * 1e3 / (later * args.ops)
          for kind in kinds[1:]}
    us["warp_move"] -= extra_moves * us["move"] / (later * args.ops)
    us["stage"] = us.pop("reg_run")
    us["decode"] = us["reg"] - us["stage"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"shape": {"rows": rows, "n": n, "dtype": "int32"},
                      "passes_timed": later, "ops_a_pass": args.ops,
                      "call_ms": ms, "us_an_op": us,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
