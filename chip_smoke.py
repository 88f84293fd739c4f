"""Drive the PyTorch/CUDA port's main path once on one CUDA card and hold
every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, one JSON line each:

  env       torch and CUDA versions, the card's name and power limit
  build     every kernel built from the sources under src/repro_torch (one
            nvcc per source, all started together)
  kernels   each kernel against its plain version (bit-exact) at every
            shape the main-path phases give it and at a sweep of sizes, and
            its time beside its bound, the plain version's and one PyTorch
            call computing the same function
  dist      dist sort, join and groupby-sum at 35 million rows on 4 logical
            ranks of cuda:0, checked against numpy
  pipeline  the ETL pipelines (python -m repro_torch.etl) under the
            heterogeneous and the batch policy on the thread executor, after
            an untimed warm-up that the launch count leaves out
  shuffle   the out-of-core shuffle's radix_bucket at 35 million rows with
            verify=True, plus one sort task and one join task

The main-path phases (dist, pipeline, shuffle) each start with every kernel's
launch count at 0 and fail unless each kernel of the path launched.  Then
come the kernel summary line, the card's name and power limit as nvidia-smi
gives them, and last ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero; without a CUDA device the script exits non-zero at once.
"""
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DIST_ROWS = 35_000_000          # the paper's dataframe size
N_RANKS = 4
PIPE_ROWS = 2_000_000           # rows per ETL task in the pipeline phase
SHUFFLE_BUCKETS = 8             # radix_bucket's buckets in the shuffle phase
HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
U64 = np.uint64


_last = [time.perf_counter()]


def emit(phase: str, **fields):
    """One JSON line per phase, with the phase's host seconds."""
    now = time.perf_counter()
    print(json.dumps({"phase": phase, "phase_s": now - _last[0], **fields}),
          flush=True)
    _last[0] = now


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
    for _ in range(warmup):
        fn()
    sync()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    sync()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def wall(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


RADIX_KERNELS = ("count_kernel", "scan_tiles_kernel", "scan_hist_kernel",
                 "rank_kernel")


def profile(fn) -> dict:
    """One run of ``fn`` under torch.profiler: the device time by kernel
    (summed; the port runs on one stream), the radix_partition kernels'
    share, and the device's idle share of the profiled wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if not busy:
        return {"profiled_wall_ms": wall_ms, "device_ms": "not measured"}
    radix = sum(v for k, v in by_name.items()
                if any(r in k for r in RADIX_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1 - busy / wall_ms, "radix_partition_ms": radix,
            "top": [[k[:80], v] for k, v in top]}


# ---------------------------------------------------------------------------
# the kernels of the port, each with its plain version and its yardstick
# ---------------------------------------------------------------------------
def _radix_library(b: torch.Tensor, n_buckets: int):
    """One stable argsort, its inverse scatter and a bincount: the same
    function from PyTorch's own operators (a yardstick only)."""
    order = torch.argsort(b, stable=True)
    dest = torch.empty_like(b)
    dest[order] = torch.arange(b.shape[0], dtype=torch.int32, device=b.device)
    return dest, torch.bincount(b, minlength=n_buckets).to(torch.int32)


def capacity(rows: int, ranks: int) -> int:
    """Rows per rank of a sharded table, as the dist phase and the ETL
    payloads size it."""
    return rows // ranks * 2 + 64


def kernel_specs():
    from repro_torch.kernels.radix_partition import ops as radix
    return [{
        "name": "radix_partition",
        "route": "cuda",
        "source": "src/repro_torch/kernels/radix_partition/csrc/"
                  "radix_partition.cu",
        "replaces": "src/repro/kernels/radix_partition/radix_partition.py:49",
        "build": radix.load,
        "wrapper": radix.radix_partition,
        "plain": radix.radix_partition_plain,
        "library": _radix_library,
        # every (n, B) the main-path phases launch the kernel at; the first
        # is the timed one
        "main_shapes": (
            # dist: one rank's shuffle pack, P + 1 buckets
            (capacity(DIST_ROWS, N_RANKS), N_RANKS + 1),
            # pipeline: each ETL task's pack on half the pool
            (capacity(PIPE_ROWS, N_RANKS // 2), N_RANKS // 2 + 1),
            # shuffle: radix_bucket over the whole input
            (DIST_ROWS, SHUFFLE_BUCKETS),
        ),
        "sweep_n": (1, 1000, 4097, DIST_ROWS),
        "sweep_b": (1, 2, 5, 65, radix.MAX_BUCKETS),
    }]


def phase_build(specs):
    from repro_torch.kernels import _nvcc
    errors = []

    def build(spec):
        try:
            spec["build"]()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(s,)) for s in specs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc={k: v["seconds"] for k, v in _nvcc.build_log.items()},
         ptxas={k: v["ptxas"] for k, v in _nvcc.build_log.items()})


def phase_kernels(specs, gen):
    """Each kernel bit-exact against its plain version at every main-path
    shape and across the sweep, then timed at the first main-path shape."""
    records = {}
    for spec in specs:
        checks, max_err = [], 0
        shapes = [(n, nb, True) for n, nb in spec["main_shapes"]] + [
            (n, nb, False) for n in spec["sweep_n"] for nb in spec["sweep_b"]]
        for n, nb, main_path in shapes:
            b = torch.randint(0, nb, (n,), dtype=torch.int32, device="cuda",
                              generator=gen)
            d, h = spec["wrapper"](b, nb)
            dp, hp = spec["plain"](b, nb)
            sync()
            err = max(int((d.long() - dp.long()).abs().max()),
                      int((h.long() - hp.long()).abs().max()))
            max_err = max(max_err, err)
            checks.append({"n": n, "buckets": nb, "main_path": main_path,
                           "max_abs_err": err})
            if err:
                raise AssertionError(f"{spec['name']} disagrees with its "
                                     f"plain version at n={n}, B={nb}")
            del d, h, dp, hp
        n, nb = spec["main_shapes"][0]
        b = torch.randint(0, nb, (n,), dtype=torch.int32, device="cuda",
                          generator=gen)
        lib_d, lib_h = spec["library"](b, nb)
        d, h = spec["wrapper"](b, nb)
        if not (torch.equal(lib_d, d) and torch.equal(lib_h, h)):
            raise AssertionError(f"{spec['name']}: library yardstick differs")
        ms = time_ms(lambda: spec["wrapper"](b, nb))
        plain_ms = time_ms(lambda: spec["plain"](b, nb), reps=5, warmup=1)
        library_ms = time_ms(lambda: spec["library"](b, nb))
        nbytes = 4 * n + 4 * n + 4 * nb     # read buckets, write dest + hist
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        records[spec["name"]] = {
            "name": spec["name"], "route": spec["route"],
            "source": spec["source"], "replaces": spec["replaces"],
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "shape": {"n": n, "buckets": nb}}
        emit("kernels", name=spec["name"], checks=checks, kernel_ms=ms,
             bound_ms=bound_ms, plain_ms=plain_ms, library_ms=library_ms,
             shape={"n": n, "buckets": nb}, tolerance="bit-exact")
    return records


class MainPath:
    """Zero every kernel's launch count before a main-path phase; after it,
    fail unless each launched, and add the counts to the kernel records."""

    def __init__(self, specs, records):
        self.specs, self.records = specs, records

    def __enter__(self):
        for s in self.specs:
            s["wrapper"].launches = 0
        return self

    def counts(self) -> dict:
        return {s["name"]: s["wrapper"].launches for s in self.specs}

    def __exit__(self, exc_type, *_):
        if exc_type is not None:
            return False
        for name, n in self.counts().items():
            if n <= 0:
                raise AssertionError(f"{name} never launched on the main path")
            self.records[name]["launches"] += n
        return False


# ---------------------------------------------------------------------------
# numpy checks of the dist phase
# ---------------------------------------------------------------------------
def _bits(v: np.ndarray) -> np.ndarray:
    return v.view(np.uint32).astype(U64)


def _u64sum(a: np.ndarray) -> int:
    return int(np.add.reduce(a.astype(U64), dtype=U64))


def _pair_sum(k: np.ndarray, v: np.ndarray) -> int:
    return _u64sum((k.astype(U64) * U64(0x9E3779B97F4A7C15)) ^ _bits(v))


def phase_dist(comm, rng):
    from repro_torch.dataframe import ops_dist as D
    n = DIST_ROWS
    cap = capacity(n, comm.size)
    a = {"k": rng.integers(0, n, n, dtype=np.int32),
         "v": rng.standard_normal(n, dtype=np.float32)}
    b = {"k": rng.integers(0, n, n, dtype=np.int32),
         "w": rng.standard_normal(n, dtype=np.float32)}
    g = {"k": rng.integers(0, 1_000_000, n, dtype=np.int32),
         "v": rng.standard_normal(n, dtype=np.float32)}
    result = {"rows": n, "ranks": comm.size, "capacity_per_rank": cap}
    torch.cuda.reset_peak_memory_stats()

    # --- sort
    ta = D.shard_table(comm, a, cap)
    sort = D.make_dist_sort(comm, "k")
    times = []
    for _ in range(2):
        (out, ovf), s = wall(lambda: sort(ta))
        times.append(s)
    if bool(ovf):
        raise AssertionError("dist_sort overflowed")
    per_rank = [sh.to_numpy() for sh in out.shards]
    got = D.collect_table(out)
    k = got["k"]
    ok = (len(k) == n and bool(np.all(k[1:] >= k[:-1]))
          and _u64sum(k) == _u64sum(a["k"])
          and _u64sum(_bits(got["v"])) == _u64sum(_bits(a["v"]))
          and _pair_sum(k, got["v"]) == _pair_sum(a["k"], a["v"]))
    ranges = [(int(r["k"][0]), int(r["k"][-1])) for r in per_rank
              if len(r["k"])]
    ok = ok and all(hi <= lo for (_, hi), (lo, _) in
                    zip(ranges, ranges[1:]))
    if not ok:
        raise AssertionError("dist_sort result disagrees with numpy")
    result["sort"] = {"wall_s": times, "rank_rows": [len(r["k"])
                                                     for r in per_rank],
                      "rank_key_ranges": ranges,
                      "profile": profile(lambda: sort(ta))}
    del out, per_rank, got

    # --- join
    tb = D.shard_table(comm, b, cap)
    join = D.make_dist_join(comm, "k", out_factor=3.0)
    times = []
    for _ in range(2):
        (out, ovf), s = wall(lambda: join(ta, tb))
        times.append(s)
    if bool(ovf):
        raise AssertionError("dist_join overflowed")
    got = D.collect_table(out)
    # matches of each left row among the right keys, and the reverse
    lcount = np.bincount(b["k"], minlength=n)[a["k"]].astype(U64)
    rcount = np.bincount(a["k"], minlength=n)[b["k"]].astype(U64)
    pairs = int(lcount.sum())
    want = {"n": pairs,
            "k": _u64sum(a["k"].astype(U64) * lcount),
            "v": _u64sum(_bits(a["v"]) * lcount),
            "w": _u64sum(_bits(b["w"]) * rcount)}
    have = {"n": len(got["k"]), "k": _u64sum(got["k"]),
            "v": _u64sum(_bits(got["v"])), "w": _u64sum(_bits(got["w"]))}
    if have != want:
        raise AssertionError(f"dist_join disagrees with numpy: {have} vs "
                             f"{want}")
    result["join"] = {"wall_s": times, "pairs": pairs,
                      "profile": profile(lambda: join(ta, tb))}
    del out, got, ta, tb

    # --- groupby-sum
    tg = D.shard_table(comm, g, cap)
    gb = D.make_dist_groupby_sum(comm, "k", ["v"])
    times = []
    for _ in range(2):
        (out, ovf), s = wall(lambda: gb(tg))
        times.append(s)
    if bool(ovf):
        raise AssertionError("dist_groupby_sum overflowed")
    got = D.collect_table(out)
    o = np.argsort(got["k"])
    sums = np.bincount(g["k"], weights=g["v"].astype(np.float64))
    keys = np.nonzero(np.bincount(g["k"]))[0]
    # float32 sums of ~35 values in atomic order against a float64 sum
    if not (np.array_equal(got["k"][o], keys)
            and np.allclose(got["v"][o], sums[keys], rtol=1e-5, atol=1e-4)):
        raise AssertionError("dist_groupby_sum disagrees with numpy")
    result["groupby"] = {"wall_s": times, "groups": int(len(keys)),
                         "tolerance": "rtol=1e-5, atol=1e-4 vs float64",
                         "profile": profile(lambda: gb(tg))}
    result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return result


def phase_pipeline():
    from repro_torch import etl
    runs = etl.run(rows=PIPE_ROWS, sort_sleep=0.0, join_sleep=0.0,
                   n_ranks=N_RANKS, device="cuda:0", timeout=600)
    return {"rows_per_task": PIPE_ROWS,
            "makespan_s": {p: rep.makespan for p, (_, rep) in runs.items()},
            "results": {p: {"/".join(k): v for k, v in res.items()
                            if k[1] in ("summarize", "merge")}
                        for p, (res, _) in runs.items()}}


def _numpy_join_summary(spec):
    from repro_torch.dataframe.shuffle import _gen_part
    left, right = _gen_part(spec, 0, 0), _gen_part(spec, 0, 1)
    rk_order = np.argsort(right["key"], kind="stable")
    rk = right["key"][rk_order]
    lo = np.searchsorted(rk, left["key"], "left")
    counts = (np.searchsorted(rk, left["key"], "right") - lo)
    li = np.repeat(np.arange(len(counts)), counts)
    ri = rk_order[lo[li] + (np.arange(len(li))
                            - (np.cumsum(counts) - counts)[li])]
    return {"n": int(len(li)), "key_sum": _u64sum(left["key"][li]),
            "v_sum": _u64sum(left["v0"][li]),
            "w_sum": _u64sum(right["w0"][ri])}


def phase_shuffle(comm, rng):
    from repro_torch.dataframe.shuffle import (_gen_part, join_task,
                                               radix_bucket, sort_task)
    n = DIST_ROWS
    cols = {"key": rng.integers(0, 1 << 30, n, dtype=np.int32),
            "v0": rng.integers(0, 1 << 30, n, dtype=np.int64)}
    nb = SHUFFLE_BUCKETS
    tgt = rng.integers(0, nb, n, dtype=np.int32)
    (chunks, hist), s = wall(lambda: radix_bucket(cols, tgt, nb,
                                                  device="cuda:0",
                                                  verify=True))
    if not (np.array_equal(hist, np.bincount(tgt, minlength=nb))
            and all(np.array_equal(c["key"], cols["key"][tgt == j])
                    for j, c in enumerate(chunks))):
        raise AssertionError("radix_bucket chunks disagree with numpy")
    _, s_plain = wall(lambda: radix_bucket(cols, tgt, nb, device="cuda:0"))
    out = {"radix_bucket": {"rows": n, "buckets": nb, "wall_s": s,
                            "wall_s_without_verify": s_plain}}
    del chunks

    spec = {"rows_per_part": 3_000_000, "seed": 5, "verify_kernel": True}
    res, s = wall(lambda: sort_task(comm, spec))
    keys = _gen_part(spec, 0)["key"]
    if not (res["sorted"] and res["n"] == len(keys)
            and res["key_sum"] == _u64sum(keys)):
        raise AssertionError(f"sort_task result {res}")
    out["sort_task"] = {"rows": spec["rows_per_part"], "wall_s": s,
                        "spills": res["spills"]}

    spec = {"rows_per_part": 2_000_000, "key_range": 4_000_000, "seed": 6,
            "verify_kernel": True}
    res, s = wall(lambda: join_task(comm, spec))
    want = _numpy_join_summary(spec)
    if any(res[k] != v for k, v in want.items()):
        raise AssertionError(f"join_task {res} vs numpy {want}")
    out["join_task"] = {"rows": spec["rows_per_part"], "wall_s": s,
                        "pairs": res["n"], "spills": res["spills"]}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.core import build_communicator, logical_devices

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=kind,
         device_count=torch.cuda.device_count(), nvidia_smi=smi)

    specs = kernel_specs()
    phase_build(specs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = phase_kernels(specs, gen)

    comm = build_communicator(logical_devices(N_RANKS, "cuda:0"))
    rng = np.random.default_rng(0)
    with MainPath(specs, records) as mp:
        res = phase_dist(comm, rng)
    emit("dist", launches=mp.counts(), **res)
    # first-use costs of the ETL payloads, before the count and the makespans
    from repro_torch import etl
    etl.warm_up(N_RANKS, "cuda:0")
    with MainPath(specs, records) as mp:
        res = phase_pipeline()
    emit("pipeline", launches=mp.counts(), **res)
    one = build_communicator(logical_devices(1, "cuda:0"))
    with MainPath(specs, records) as mp:
        res = phase_shuffle(one, rng)
    emit("shuffle", launches=mp.counts(), **res)

    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
