"""Time this checkout's build of a kernel against another build, in turns
(other, this, this, other), in one process on one card, through the
kernels' wrappers; with ``--split``, also list where one call's device time
goes, launch by launch.

    PYTHONPATH=src python -m repro_torch.kernels.ab KERNEL \\
        [--other-ops path/to/ops.py] [--other-source path/to/KERNEL.cu] \\
        [--other-define NAME=VALUE ...] [--shape ...] [--reps 50] [--split] \\
        [--probe]

KERNEL is ``flash_attention``, ``bitonic_sort``, ``ssm_scan`` or
``radix_partition``.  The other build is the wrapper module
``--other-ops`` (by default this checkout's ``ops.py`` of KERNEL; an older
checkout's, unpacked with ``git archive`` into an ignored directory, holds
its kernel source beside it in ``csrc/``), loaded afresh under a name of
its own with its own library.
``--other-source`` replaces its kernel source, and each ``--other-define
NAME=VALUE`` one of its top-level constants before it runs
(``LOG_CHUNK=12``, ``KV_STAGES=3``, ``COSTS={...}``, ``LANES=16``), so one
wrapper and source can be held against themselves built and planned with
other constants.  Both outputs
are first held against this checkout's plain version: ``flash_attention``
within its bf16 tolerance, ``bitonic_sort`` bit for bit (keys as bits,
payloads), ``ssm_scan``'s y and final state within 1e-5 + 1e-5 * |plain|
(its ``max_abs_err`` is the largest |kernel - plain| over that bound),
``radix_partition``'s destinations and histogram bit for bit.

``--split`` profiles ``--split-calls`` calls of each build with
``torch.profiler`` (a synchronise after each) and gives, for each launch
of one call in order, its device kernel's name and median time, and the
median gap before it (negative where a launch overlaps the one before).
The profiler's own launch overhead widens the gaps, so the turns'
CUDA-event times are the calls' times.

With ``--probe`` the other build is timed even where it disagrees with
the plain version (a probe: a build with a part taken out on purpose, to
see what the part costs); ``agrees`` in the output says which builds
agreed, and this checkout's build must agree in any case.

Prints one JSON line: each turn's median time in ms over ``--reps`` calls
(CUDA events, after a warm-up), each build's host time a call (enqueueing
only), the split, the card's name and power limit, and what ptxas reported
for each build made here.
"""
from __future__ import annotations

import argparse
import ast
import importlib
import json
import statistics
import subprocess
import time
import types
from pathlib import Path

import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels import bitonic_sort as _bs_pkg
from repro_torch.kernels import flash_attention as _fa_pkg
from repro_torch.kernels import radix_partition as _radix_pkg
from repro_torch.kernels import ssm_scan as _ssm_pkg

_PACKAGES = {"flash_attention": _fa_pkg, "bitonic_sort": _bs_pkg,
             "ssm_scan": _ssm_pkg, "radix_partition": _radix_pkg}


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


def _host_ms(fn, reps: int) -> float:
    """Median host time of one call of ``fn``, without waiting for the
    card (what it costs the caller's thread to enqueue the work)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def load_other(kernel: str, ops_path: Path, source: Path | None,
               defines: list):
    """A fresh module of the wrapper at ``ops_path`` whose library is built
    under its own name (so it never meets this checkout's build).  Each
    NAME=VALUE of ``defines`` replaces the module's top-level assignment
    ``NAME = ...`` before the module runs, so the wrapper's -D flags and
    whatever it derives from them (a plan, a grid) change together."""
    text = ops_path.read_text()
    for d in defines:
        name, value = d.split("=", 1)
        lines = text.splitlines(keepends=True)
        spans = [(node.lineno, node.end_lineno)
                 for node in ast.parse(text).body
                 if isinstance(node, ast.Assign) and len(node.targets) == 1
                 and getattr(node.targets[0], "id", None) == name]
        if not spans:
            raise SystemExit(f"ab: {ops_path} assigns no {name} at its top "
                             f"level")
        first, last = spans[0]
        text = "".join(lines[:first - 1] + [f"{name} = {value}\n"]
                       + lines[last:])
    mod = types.ModuleType(f"_ab_other_{kernel}")
    mod.__file__ = str(ops_path.resolve())
    exec(compile(text, mod.__file__, "exec"), mod.__dict__)
    if source is not None:
        mod._SOURCE = source.resolve()
    mod.load_library = lambda name, src, defines=None: _nvcc.load_library(
        f"{name}_other", src, defines=defines)
    return mod


def _attention_case(shape: str, this):
    b, h, kh, s, hd = (int(x) for x in shape.split(","))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(dims, generator=gen, device="cuda").bfloat16()
               for dims in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
    plain = this.flash_attention_plain(q, k, v).float()

    def check(out):
        diff = (out.float() - plain).abs()
        return bool((diff <= 2e-2 + 2e-2 * plain.abs()).all()), \
            float(diff.max())
    return ((lambda mod: mod.flash_attention(q, k, v)), check,
            {"B": b, "H": h, "K": kh, "S": s, "hd": hd, "dtype": "bfloat16",
             "causal": True})


def _sort_case(shape: str, this):
    rows, n, dtype = shape.split(",")
    rows, n = int(rows), int(n)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if dtype == "int32":      # benchmarks/bench_kernels.py's keys
        keys = torch.randint(0, 1 << 30, (rows, n), generator=gen,
                             device="cuda", dtype=torch.int32)
    elif dtype == "float32":
        keys = torch.randn(rows, n, generator=gen, device="cuda")
    else:
        raise SystemExit(f"ab: bitonic_sort keys are int32 or float32, not "
                         f"{dtype}")
    kp, pp = this.bitonic_sort_plain(keys)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def check(out):
        ks, ps = out
        ok = torch.equal(bits(ks), bits(kp)) and torch.equal(ps, pp)
        return bool(ok), float((ks.double() - kp.double()).abs().max())
    return ((lambda mod: mod.bitonic_sort(keys)), check,
            {"rows": rows, "n": n, "dtype": dtype})


def _scan_case(shape: str, this):
    """``B,S,D,N[,f32|,f16][,long|,mamba2]`` (``accuracy.parse_shape``): a
    bf16 model's dtypes unless ``f32`` or ``f16``, softplus inputs unless
    ``long`` or ``mamba2`` (``accuracy.inputs``), the final state
    returned."""
    from repro_torch.kernels.ssm_scan import accuracy
    b, s, d, n, dtypes, kind = accuracy.parse_shape(shape)
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = accuracy.inputs(b, s, d, n, dtypes, kind, gen=gen)
    plain = this.ssm_scan_plain(*args, return_state=True)

    def check(out):
        """Held if every |kernel - plain| is within its bound; the error
        given is the largest |kernel - plain| over its bound."""
        worst = max(accuracy.over_bound(o, r)
                    for o, r in zip(out, plain, strict=True))
        return worst <= 1, worst
    return ((lambda mod: mod.ssm_scan(*args, return_state=True)), check,
            {"B": b, "S": s, "D": d, "N": n, "dtypes": dict(zip(
                ("dt", "x", "Bm", "Cm"),
                (str(t).removeprefix("torch.") for t in dtypes),
                strict=True)),
             "inputs": kind, "return_state": True})


def radix_buckets(n: int, n_buckets: int, dist: str, gen) -> torch.Tensor:
    """(n,) int32 bucket ids on the card: ``uniform`` in [0, n_buckets),
    the same ``sorted`` ascending (long runs of one bucket), or ``hot``:
    bucket 0 for 90 % of the rows and the rest uniform."""
    b = torch.randint(0, n_buckets, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    if dist == "sorted":
        return torch.sort(b).values
    if dist == "hot":
        cold = torch.rand(n, generator=gen, device="cuda") >= 0.9
        return torch.where(cold, b, 0)
    if dist != "uniform":
        raise SystemExit(f"ab: radix_partition inputs are uniform, sorted "
                         f"or hot, not {dist}")
    return b


def _radix_case(shape: str, this):
    n, nb, *rest = shape.split(",")
    n, nb, dist = int(n), int(nb), (rest or ["uniform"])[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = radix_buckets(n, nb, dist, gen)
    dp, hp = this.radix_partition_plain(b, nb)

    def check(out):
        d, h = out
        err = max(int((d.long() - dp.long()).abs().max()),
                  int((h.long() - hp.long()).abs().max()))
        return torch.equal(d, dp) and torch.equal(h, hp), err
    return ((lambda mod: mod.radix_partition(b, nb)), check,
            {"n": n, "buckets": nb, "dist": dist})


_CASES = {"flash_attention": (_attention_case, "1,32,8,2048,128"),
          "bitonic_sort": (_sort_case, "4,262144,int32"),
          "ssm_scan": (_scan_case, "1,2048,8192,16"),
          "radix_partition": (_radix_case, "17500064,5")}


def split(fn, calls: int) -> dict:
    """Device kernels of one call of ``fn`` in launch order: each one's
    median time and the median gap before it (from the previous kernel's
    end, or for the first from the first kernel's start of the same call,
    so 0), over ``calls`` profiled calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.time_range.elapsed_us() > 0),
                    key=lambda e: e.time_range.start)
    if not events or len(events) % calls:
        return {"device_events": len(events), "calls": calls,
                "note": "not measured: the events do not split into calls"}
    per = len(events) // calls
    launches = []
    for i in range(per):
        group = events[i::per]
        gaps = [0.0 if i == 0 else
                (events[c * per + i].time_range.start
                 - events[c * per + i - 1].time_range.end) / 1e3
                for c in range(calls)]
        launches.append([group[0].name[:60],
                         statistics.median(e.time_range.elapsed_us() / 1e3
                                           for e in group),
                         statistics.median(gaps)])
    spans = [(events[c * per + per - 1].time_range.end
              - events[c * per].time_range.start) / 1e3
             for c in range(calls)]
    return {"launches_per_call": per,
            "kernels_ms": sum(x[1] for x in launches),
            "gaps_ms": sum(x[2] for x in launches),
            "span_ms": statistics.median(spans),
            "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(_PACKAGES))
    ap.add_argument("--other-ops", type=Path,
                    help="the other build's ops.py (default: this one's)")
    ap.add_argument("--other-source", type=Path,
                    help="the other build's kernel source")
    ap.add_argument("--other-define", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="a top-level constant of the other wrapper")
    ap.add_argument("--shape", help="flash_attention: B,H,K,S,hd (bf16, "
                    "causal); bitonic_sort: rows,n,int32|float32; ssm_scan: "
                    "B,S,D,N[,f32|,f16][,long|,mamba2]; radix_partition: "
                    "n,B[,uniform|sorted|hot]")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--split", action="store_true",
                    help="profile each build's launches")
    ap.add_argument("--split-calls", type=int, default=10)
    ap.add_argument("--probe", action="store_true",
                    help="time the other build even where it disagrees "
                    "with the plain version: a probe with a part taken out "
                    "on purpose, to see what that part costs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab: no CUDA device is visible")
    pkg = _PACKAGES[args.kernel]
    this = importlib.import_module(f"{pkg.__name__}.ops")
    other = load_other(args.kernel, args.other_ops or Path(this.__file__),
                       args.other_source, args.other_define)
    make_case, default_shape = _CASES[args.kernel]
    call, check, shape = make_case(args.shape or default_shape, this)
    runs = {"other": lambda: call(other), "this": lambda: call(this)}
    errs, agrees = {}, {}
    for name, fn in runs.items():
        agrees[name], errs[name] = check(fn())
        torch.cuda.synchronize()
        if not agrees[name] and not (args.probe and name == "other"):
            raise AssertionError(f"{name} disagrees with the plain version: "
                                 f"max abs err {errs[name]}")
    turns = [[name, _median_ms(runs[name], args.reps)]
             for name in ("other", "this", "this", "other")]
    host = {name: _host_ms(fn, args.reps) for name, fn in runs.items()}
    splits = ({name: split(fn, args.split_calls)
               for name, fn in runs.items()} if args.split else None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"kernel": args.kernel,
                      "other_ops": str(args.other_ops or "this"),
                      "other_source": str(args.other_source or "its own"),
                      "other_defines": args.other_define, "shape": shape,
                      "turns_ms": turns, "host_ms": host,
                      "max_abs_err": errs, "agrees": agrees,
                      "split": splits,
                      # registers, stack and spills of each build made here
                      "ptxas": {name: [line.split("info    : ")[-1]
                                       for line in log["ptxas"].splitlines()
                                       if "Used" in line or "stack" in line]
                                for name, log in _nvcc.build_log.items()},
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
