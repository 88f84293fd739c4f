"""The readings that a cell's limits are set from: for each seed, the
number the benchmark compares as a sound run of the program gives it, and
as the control gives it on the same work.

    python3 perfbench/tools/control.py --workload <name> --seconds 10 \
        --seeds 101 102 103 ...

Each seed makes its own inputs and weights, runs a short window at the
cell's own load and sizes, and compares as a run does; all seeds run in one
process.  The control is the configuration's reference put in the
program's place one step below what the configuration states:

* a served bfloat16 model: the float32 reference with every product's
  operands rounded to float8 e4m3 (``quant="fp8"``); at each position of
  the same prompts and served tokens, the gap of the token it puts first;
* exact dataframe results: the reference's rows with the float columns
  moved as bfloat16 (``ref.control``).

Prints one JSON line a seed (also appended to ``--out``).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def serving(drv) -> dict:
    uids = drv.sample()
    prompts = [drv.req[u]["prompt"] for u in uids]
    served = [drv.results[u] for u in uids]
    t = time.perf_counter()
    prog = drv.ref.served_gaps(drv.weights, drv.cfg, prompts, served)
    t_ref = time.perf_counter() - t
    ctrl = drv.ref.served_gaps(drv.weights, drv.cfg, prompts, served,
                               quant="fp8")
    flips = sum(int((g > 0).sum()) for g in ctrl)
    return {"requests": len(uids), "tokens": int(sum(len(s) for s in served)),
            "program_logit_gap": float(max(g.max() for g in prog)),
            "program_tokens_off_argmax": sum(int((g > 0).sum()) for g in prog),
            "control_logit_gap": float(max(g.max() for g in ctrl)),
            "control_tokens_off_argmax": flips, "reference_s": t_ref}


def dataframe(drv) -> dict:
    prog = drv.check()
    ctrl = 0
    for i in sorted(drv.kept):
        raw = drv.inputs[i % len(drv.inputs)][0]
        key = drv.cfg["key"]
        if drv.traffic["op"] == "dist_join":
            want = drv.ref.join(raw[0][key], raw[0]["v"], raw[1][key],
                                raw[1]["w"], drv.cfg["key_range"])
        else:
            want = drv.ref.sort(raw[0][key], raw[0]["v"])[1]
        ctrl += drv.ref.rows_wrong(drv.ref.control(want), want)
    return {"tasks": drv.compared, "program_rows_wrong": prog[0][1],
            "control_rows_wrong": ctrl}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", help="a JSONL file to append each line to")
    args = ap.parse_args()
    import torch

    from yardstick.cell import Cell
    from yardstick.runner import NoTrace, emit
    cell = Cell(args.workload)
    for seed in args.seeds:
        drv = cell.driver().Driver(cell, seed, torch.device("cuda:0"), {})
        drv.setup()
        drv.run(args.seconds, NoTrace())
        drv.release()
        rec = {"workload": args.workload, "seed": seed,
               "attempted": drv.attempted, "failed": drv.failed}
        rec.update(serving(drv) if hasattr(drv, "sample") else dataframe(drv))
        emit(rec, args.out)
        del drv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
