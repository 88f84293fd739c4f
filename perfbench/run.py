"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one run of one
cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Makes its inputs and weights from the seed, warms up (counted as set-up),
measures for ``--seconds``, holds what the timed path produced to the plain
reference, and prints one JSON object as the last line of standard output:
the end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``.  Exits non-zero with no result when the card or the cards the
cell asks for are missing, or when JAX or the JAX package got loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _environment():
    """The port from this checkout, its nvcc builds inside it
    (``src/repro_torch/kernels/build``), and none of the runtime's
    environment knobs (trace files, checkpoint roots, result caches)."""
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    for k in [k for k in os.environ if k.startswith("REPRO_")]:
        del os.environ[k]
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from yardstick.cell import Cell
    from yardstick.runner import forbidden_modules, print_result, run_cell

    cell = Cell(args.workload)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device is visible: the benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   T_PROCESS, device="cuda:0", cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
