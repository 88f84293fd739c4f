"""Time this checkout's flash_attention kernel against one built from another
source file, in turns (other, this, this, other), in one process on one card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ab \\
        --other path/to/flash_attention.cu [--other-define KV_STAGES=3] \\
        [--shape 1,32,8,2048,128]

The other source must export the same C entry point,
``flash_attention_launch``; it is built with this checkout's ``-D`` flags
(a source ignores the ones it does not read), each ``--other-define``
replacing one, so the same source can be held against itself built with
other constants.  Both outputs are first held against the plain version at
the wrapper's bf16 tolerance.  Prints one JSON line: each turn's median
time in ms over ``--reps`` launches (CUDA events, after a warm-up), the
card's name and power limit, and what ptxas reported for each build.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels._nvcc import build_log, load_library
from repro_torch.kernels.flash_attention import ops as fa


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other flash_attention.cu")
    ap.add_argument("--other-define", action="append", default=[],
                    metavar="NAME=VALUE", help="a -D flag of the other build")
    ap.add_argument("--shape", default="1,32,8,2048,128",
                    help="B,H,K,S,hd (bf16, causal)")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab: no CUDA device is visible")
    b, h, kh, s, hd = (int(x) for x in args.shape.split(","))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(dims, generator=gen, device="cuda").bfloat16()
               for dims in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
    this = fa.load()
    defines = dict(fa.DEFINES)
    defines.update(d.split("=", 1) for d in args.other_define)
    other = fa.entry_point(load_library("flash_attention_other", args.other,
                                        defines=defines))
    plain = fa.flash_attention_plain(q, k, v).float()
    runs = {"other": lambda: fa.call_entry(other, q, k, v, True),
            "this": lambda: fa.call_entry(this, q, k, v, True)}
    errs = {}
    for name, fn in runs.items():
        diff = (fn().float() - plain).abs()
        torch.cuda.synchronize()
        if not bool((diff <= 2e-2 + 2e-2 * plain.abs()).all()):
            raise AssertionError(f"{name} disagrees with the plain version: "
                                 f"max abs err {float(diff.max())}")
        errs[name] = float(diff.max())
    turns = []
    for name in ("other", "this", "this", "other"):
        turns.append([name, _median_ms(runs[name], args.reps)])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"other": str(args.other),
                      "other_defines": args.other_define,
                      "shape": {"B": b, "H": h, "K": kh, "S": s, "hd": hd,
                                "dtype": "bfloat16", "causal": True},
                      "turns_ms": turns, "max_abs_err": errs,
                      # registers, stack and spills of each build made here
                      "ptxas": {name: [line.split("info    : ")[-1]
                                       for line in log["ptxas"].splitlines()
                                       if "Used" in line or "stack" in line]
                                for name, log in build_log.items()},
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
