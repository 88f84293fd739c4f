"""Drive the PyTorch/CUDA port's main path once on one CUDA card and hold
every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, one JSON line each:

  env       torch and CUDA versions, the card's name and power limit
  build     every kernel built from the sources under src/repro_torch (one
            nvcc per source, all started together)
  kernels   each kernel against its plain version at every shape the
            main-path phases give it and at a sweep of sizes (radix_partition
            bit-exact, ids outside [0, B) left at dest -1 and uncounted, a
            second call bit-identical; flash_attention within 2e-5 in f32
            and 2e-2 in bf16, and a bf16 result also within 4e-3 + 2e-2 *
            |plain| of the plain version run in f32; ssm_scan's y and final state within
            1e-5 + 1e-5 * |plain|, whatever the inputs' dtypes, and a second
            call bit-identical;
            bitonic_sort's keys and payloads bit-identical), and its time
            beside its bound, the plain version's and one PyTorch call
            computing the same function, where there is one
  dist      dist sort, join and groupby-sum at 35 million rows on 4 logical
            ranks of cuda:0, checked against numpy
  pipeline  the ETL pipelines (python -m repro_torch.etl) under the
            heterogeneous and the batch policy on the thread executor, after
            an untimed warm-up that the launch count leaves out
  shuffle   the out-of-core shuffle's radix_bucket at 35 million rows with
            verify=True, plus one sort task and one join task
  serve     qwen3-8b at its published widths in bf16 (random weights from a
            seeded generator), 4 logical ranks of cuda:0, through both acts
            of python -m repro_torch.serve_lm: the static engine as a task
            beside an ETL dist sort, then the continuous engine through
            ServeDriver beside ETL sorts; then prefill and decode times and
            a profile of one 2048-token prefill
  serve_f32 the same widths with 2 layers in float32 (TF32 off): the
            continuous engine's tokens equal the full-forward oracle's
  serve_ssm falcon-mamba-7b at its published widths in bf16, the same two
            acts, requests and timings as serve (after the qwen3-8b weights
            are freed); ssm_scan launches once per layer per prefill
  serve_ssm_f32  falcon-mamba-7b's widths with 2 layers in float32 (TF32
            off for matmuls and cuDNN): the continuous engine's tokens equal
            the full-forward oracle's
  sort      bitonic_sort's own path, the row sorts of the JAX package's
            benchmark (4 rows of 2^18 int32 keys in [0, 2^30),
            benchmarks/bench_kernels.py) and of its test sweep, through the
            wrapper: keys equal the stable oracle's (its ref.sort_ref),
            payloads regather them

The main-path phases (dist, pipeline, shuffle, the four serve phases and
sort)
each start with every kernel's launch count at 0 and fail unless each
kernel that the phase's path runs launched (serve_ssm: exactly once per
layer per prefill).  Then come the kernel summary line, the card's name
and power limit as nvidia-smi gives them, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero at once.
"""
import functools
import gc
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
SERVE_ARCH = "qwen3-8b"
SSM_ARCH = "falcon-mamba-7b"
SERVE_PROMPTS = [2048, 2048, 1024, 1024, 512, 512, 1536, 768]
SERVE_BUDGETS = [16, 32] * 4    # max_new_tokens of each serve request
SERVE_MAX_BATCH, SERVE_MAX_SEQ = 4, 4096
F32_PROMPTS, F32_NEW = [300, 77, 129], 8      # the f32 token check
HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores (same)
# exponentials: 16 a clock per SM (CUDA programming guide, compute
# capability 9.0), 132 SMs at the 1.98 GHz boost clock
H100_EXP_PER_S = 16 * 132 * 1.98e9
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


RADIX_KERNELS = ("radix_hist_", "radix_rank_")
# device-kernel names of each port kernel, as the profiler reports them
KERNEL_NAMES = {"radix_partition": RADIX_KERNELS,
                "flash_attention": ("flash_attention_",),
                "ssm_scan": ("ssm_scan_kernel",)}


def profile(fn) -> dict:
    """One run of ``fn`` under torch.profiler: the device time by kernel
    (summed; the port runs on one stream), each port kernel's share, and
    the device's idle share of the profiled wall time."""
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
    out = {"profiled_wall_ms": wall_ms, "device_ms": busy,
           "idle_share": 1 - busy / wall_ms}
    for kernel, names in KERNEL_NAMES.items():
        out[f"{kernel}_ms"] = sum(v for k, v in by_name.items()
                                  if any(r in k for r in names))
        out[f"{kernel}_share"] = out[f"{kernel}_ms"] / busy
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["top"] = [[k[:80], v] for k, v in top]
    return out


# ---------------------------------------------------------------------------
# the kernels of the port, each with its plain version and its yardstick
# ---------------------------------------------------------------------------
def capacity(rows: int, ranks: int) -> int:
    """Rows per rank of a sharded table, as the dist phase and the ETL
    payloads size it."""
    return rows // ranks * 2 + 64


def _radix_library(b: torch.Tensor, n_buckets: int):
    """One stable argsort, its inverse scatter and a bincount: the same
    function from PyTorch's own operators (a yardstick only)."""
    order = torch.argsort(b, stable=True)
    dest = torch.empty_like(b)
    dest[order] = torch.arange(b.shape[0], dtype=torch.int32, device=b.device)
    return dest, torch.bincount(b, minlength=n_buckets).to(torch.int32)


def _radix_spec():
    from repro_torch.kernels.ab import radix_buckets
    from repro_torch.kernels.radix_partition import ops as radix
    tile = radix.TILE

    def inputs(shape, gen):
        """(n, B[, kind]): ids uniform in [0, B) unless ``kind`` says
        ``sorted`` (long runs), ``hot`` (90 % of the rows in bucket 0),
        ``one`` (every row in bucket B - 1), ``oob`` (every fifth row an id
        outside [0, B)) or ``unaligned`` (the view ``base[1:]``, 4 bytes past
        a 16-byte boundary)."""
        n, nb = shape[:2]
        kind = shape[2] if len(shape) > 2 else "uniform"
        if kind == "one":
            return torch.full((n,), nb - 1, dtype=torch.int32,
                              device="cuda"), nb
        if kind == "unaligned":
            return radix_buckets(n + 1, nb, "uniform", gen)[1:], nb
        b = radix_buckets(n, nb, "uniform" if kind == "oob" else kind, gen)
        if kind == "oob":
            bad = torch.tensor([-1, nb, nb + 7, -2 ** 31, 2 ** 31 - 1],
                               dtype=torch.int32, device="cuda")
            rows = torch.arange(0, n, 5, device="cuda")
            b[rows] = bad[rows % len(bad)]
        return b, nb

    def plain(b, nb):
        """The plain version; where ids lie outside [0, B), the plain version
        over the other rows, and dest -1 for those (the kernel's contract:
        neither counted nor placed)."""
        ok = (b >= 0) & (b < nb)
        if bool(ok.all()):
            return radix.radix_partition_plain(b, nb)
        dest = torch.full_like(b, -1)
        d, h = radix.radix_partition_plain(b[ok].contiguous(), nb)
        dest[ok] = d
        return dest, h

    def compare(out, ref, args, yardstick=False, shape=()):
        """Largest difference of dest and hist (integers: exact); the kernel
        must also give the same bits on a second call."""
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(out, ref, strict=True))
        if yardstick:
            return err, err == 0, {}
        again = radix.radix_partition(*args)
        same = all(torch.equal(o, a) for o, a in zip(out, again, strict=True))
        return err, err == 0 and same, {"repeat_bit_identical": same}

    def bound(shape):
        n, nb = shape[:2]
        nbytes = 4 * n + 4 * n + 4 * nb     # read buckets, write dest + hist
        return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"

    def describe(shape):
        return {"n": shape[0], "buckets": shape[1],
                **({"ids": shape[2]} if len(shape) > 2 else {})}

    main_shapes = (
        # dist: one rank's shuffle pack, P + 1 buckets
        (capacity(DIST_ROWS, N_RANKS), N_RANKS + 1),
        # pipeline and serve: each ETL task's pack on half the pool
        (capacity(PIPE_ROWS, N_RANKS // 2), N_RANKS // 2 + 1),
        # shuffle: radix_bucket over the whole input
        (DIST_ROWS, SHUFFLE_BUCKETS),
    )
    # bucket counts on each side of the kernel's edges: past 8 a warp scans
    # two buckets' counters, past SMALL_BUCKETS the strategy changes
    edges = (4, 5, 8, 9, radix.SMALL_BUCKETS, radix.SMALL_BUCKETS + 1)
    return {
        "name": "radix_partition",
        "route": "cuda",
        "source": "src/repro_torch/kernels/radix_partition/csrc/"
                  "radix_partition.cu",
        "replaces": "src/repro/kernels/radix_partition/radix_partition.py:49",
        "build": radix.load,
        "wrapper": radix.radix_partition,
        "plain": plain,
        "library": _radix_library,
        "inputs": inputs, "compare": compare, "bound": bound,
        "tolerance": "bit-exact; ids outside [0, B) get dest -1 and are not "
                     "counted; a second call bit-identical",
        "describe": describe,
        # every (n, B) the main-path phases launch the kernel at; the first
        # is the summary line's, and all three are timed
        "main_shapes": main_shapes,
        "timed": main_shapes,
        "sweep": (
            *((n, nb) for n in (1, 1000, 4097, DIST_ROWS)
              for nb in (1, 2, 5, 65, radix.MAX_BUCKETS)),
            # the timed shape's ids in long runs, with a hot bucket, and in
            # one bucket; ids out of range; an unaligned view
            *((capacity(DIST_ROWS, N_RANKS), N_RANKS + 1, kind)
              for kind in ("sorted", "hot", "one", "oob", "unaligned")),
            # tile edges, n no multiple of 4, at each strategy edge
            *((n, nb, kind) for n in (tile - 1, tile + 1, 2 * tile + 3)
              for nb in edges for kind in ("uniform", "unaligned")),
            *((2 * tile + 3, nb, "oob") for nb in edges),
            (1 << 20, 65, "oob"), (1 << 20, radix.MAX_BUCKETS, "oob"),
            (DIST_ROWS, radix.MAX_BUCKETS, "hot"),
            (DIST_ROWS - 1, SHUFFLE_BUCKETS, "unaligned"),
        ),
    }


BF16_TOL, F32_TOL = 2e-2, 2e-5
BF16_F32_ATOL = 4e-3            # bf16 kernel against the plain version in f32
H100_BF16_FLOPS = 989e12        # dense tensor-core peak (NVIDIA data sheet)


def _attention_library(q, k, v):
    """scaled_dot_product_attention on the same inputs (a yardstick only;
    the port never calls it)."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    return out.transpose(1, 2)


def _attention_spec():
    from repro_torch.kernels.flash_attention import ops as fa

    def inputs(shape, gen):
        b, h, kh, s, hd, dtype = shape
        return tuple(
            torch.randn(dims, generator=gen, device="cuda").to(dtype)
            for dims in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))

    def compare(out, ref, args, yardstick=False, shape=()):
        """Largest absolute difference from the plain version, and whether
        every element is within tol + tol * |plain| (tol 2e-2 in bf16: the
        plain version rounds the scores to bf16 as the JAX einsum does, the
        kernel keeps them in f32).  A bf16 kernel result is also held to the
        plain version run in f32 on the same inputs, within BF16_F32_ATOL +
        tol * |plain|: that leaves only the kernel's own roundings (P and
        the output to bf16), so it holds the small outputs of a long
        prompt's late rows, which average hundreds of values, to their own
        size.  The library yardstick takes only the first check."""
        tol = BF16_TOL if out.dtype == torch.bfloat16 else F32_TOL
        diff = (out.float() - ref.float()).abs()
        ok = bool((diff <= tol + tol * ref.float().abs()).all())
        info = {}
        if out.dtype == torch.bfloat16 and not yardstick:
            ref32 = fa.flash_attention_plain(*(a.float() for a in args))
            diff32 = (out.float() - ref32).abs()
            info["max_abs_err_vs_f32_plain"] = float(diff32.max())
            ok = ok and bool(
                (diff32 <= BF16_F32_ATOL + tol * ref32.abs()).all())
        return float(diff.max()), ok, info

    def bound(shape):
        b, h, kh, s, hd, dtype = shape
        flops = 4 * hd * h * b * s * (s + 1) / 2        # causal pairs
        size = 2 if dtype == torch.bfloat16 else 4
        nbytes = size * hd * b * s * (2 * h + 2 * kh)   # q, o, k, v once
        by_ops = flops / H100_BF16_FLOPS * 1e3
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return max(by_ops, by_bytes), \
            "operations" if by_ops >= by_bytes else "bytes"

    def describe(shape):
        b, h, kh, s, hd, dtype = shape
        return {"B": b, "H": h, "K": kh, "S": s, "hd": hd,
                "dtype": str(dtype).removeprefix("torch.")}

    bf16, f32 = torch.bfloat16, torch.float32
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:59",
        "build": fa.load,
        "wrapper": fa.flash_attention,          # causal by default
        "plain": fa.flash_attention_plain,
        "library": _attention_library,
        "inputs": inputs, "compare": compare, "bound": bound,
        "tolerance": f"|kernel - plain| <= tol + tol * |plain|, tol "
                     f"{F32_TOL} (f32), {BF16_TOL} (bf16); a bf16 kernel "
                     f"also |kernel - plain in f32| <= {BF16_F32_ATOL} + "
                     f"{BF16_TOL} * |plain in f32|",
        "describe": describe,
        # (B, H, K, S, hd, dtype) of every prefill and forward of the serve
        # phases; the first is the timed one.  serve_f32's oracle runs a
        # forward at every length from the prompt's to the prompt's plus
        # F32_NEW - 1, and the engine's prefill at the prompt's.
        "main_shapes": (
            *((1, 32, 8, s, 128, bf16) for s in sorted(set(SERVE_PROMPTS),
                                                       reverse=True)),
            *((2, 32, 8, s, 128, bf16) for s in sorted(
                {s for s in SERVE_PROMPTS if SERVE_PROMPTS.count(s) > 1})),
            *((1, 32, 8, s + d, 128, f32) for s in F32_PROMPTS
              for d in range(F32_NEW)),
        ),
        "sweep": tuple(
            (b, h, kh, s, hd, dtype)
            for b, s, h, kh, hd in ((1, 128, 4, 4, 32), (2, 256, 8, 2, 64),
                                    (1, 130, 8, 8, 32), (2, 384, 6, 3, 128),
                                    (1, 1, 4, 2, 16), (1, 17, 8, 2, 128))
            for dtype in (f32, bf16)),
    }


SSM_TOL = 1e-5                  # tests/test_kernels.py's f32 tolerance
F32, BF16 = torch.float32, torch.bfloat16
SSM_MODEL_MIX = (F32, BF16, BF16, BF16)     # dt, x, Bm, Cm in a bf16 model
SSM_F32_MIX = (F32,) * 4


def _ssm_spec():
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import accuracy
    from repro_torch.kernels.ssm_scan import ops as ssm
    cfg = get_config(SSM_ARCH)
    d_inner, n_state, dt_rank = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    zamba = get_config("zamba2-7b")

    def inputs(shape, gen):
        """``accuracy.inputs``: dt = softplus(normal), A = -exp(0.3 normal),
        or with "long" Mamba's own ranges (each channel's dt around a level
        drawn log-uniform in [0.001, 0.1], A = -(1..N)); Bm, Cm column
        slices of one (B, S, dt_rank + 2N) tensor, as the model's x_db
        gives them."""
        b, s, d, n, dtypes = shape[:5]
        kind = "long" if "long" in shape[5:] else "softplus"
        return accuracy.inputs(b, s, d, n, dtypes, kind, gen=gen,
                               dt_rank=dt_rank)

    def compare(out, ref, args, yardstick=False, shape=()):
        """Largest absolute difference of y and of the final state, and
        whether every element is within SSM_TOL + SSM_TOL * |plain|: both
        sides compute in f32 from the same values.  A second call must give
        the same bits (no atomics: the sums run in a fixed order).

        A shape marked "f64" is held to the float64 scan of the same values
        instead (``accuracy.held_to_f64``): the state within SSM_TOL +
        SSM_TOL * |exact|, y within SSM_TOL + SSM_TOL * sum_n |h_n C_n|.
        That is zamba2's width, where y sums 64 products of |h C| up to
        about 40: where they cancel, two f32 sums in different orders
        differ by more than SSM_TOL + SSM_TOL * |y|, and the plain version
        itself lies that far from float64 (PERF.md).  Its errors against
        the plain version and both sides' against float64 over the usual
        bound are reported beside."""
        err = max(float((o - r).abs().max())
                  for o, r in zip(out, ref, strict=True))
        worst = max(accuracy.over_bound(o, r)
                    for o, r in zip(out, ref, strict=True))
        again = ssm.ssm_scan(*args, return_state=True)
        same = all(torch.equal(o, a) for o, a in zip(out, again, strict=True))
        # worst_of_tolerance: the largest |kernel - plain| over its bound
        info = {"repeat_bit_identical": same, "worst_of_tolerance": worst}
        if "f64" not in (shape or ())[5:]:
            return err, worst <= 1 and same, info
        exact = accuracy.scan_f64(*args)
        info["kernel_vs_f64"], info["plain_vs_f64"] = (
            max(accuracy.over_bound(o, e)
                for o, e in zip(res, exact[:2], strict=True))
            for res in (out, ref))
        info["held_to_f64"] = accuracy.held_to_f64(out, exact)
        return err, info["held_to_f64"] <= 1 and same, info

    def bound(shape):
        """Bytes: dt, x, Bm, Cm and A read once, y and the state written
        once.  Operations: B*S*D*N exponentials and 6 f32 FLOPs each
        (dt*A, the state's multiply-add, dt*x*B, the C product's
        multiply-add)."""
        b, s, d, n, dtypes = shape[:5]
        size = {F32: 4, BF16: 2}
        t_dt, t_x, t_b, t_c = (size[t] for t in dtypes)
        nbytes = (b * s * d * (t_dt + t_x + 4) + b * s * n * (t_b + t_c)
                  + d * n * 4 + b * d * n * 4)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = max(b * s * d * n / H100_EXP_PER_S,
                     6 * b * s * d * n / H100_F32_FLOPS) * 1e3
        return max(by_ops, by_bytes), \
            "operations" if by_ops >= by_bytes else "bytes"

    def describe(shape):
        b, s, d, n, dtypes = shape[:5]
        return {"B": b, "S": s, "D": d, "N": n, "dtypes": dict(zip(
            ("dt", "x", "Bm", "Cm"),
            (str(t).removeprefix("torch.") for t in dtypes), strict=True)),
            **({"long_memory": True} if "long" in shape[5:] else {}),
            **({"held_to": "float64"} if "f64" in shape[5:] else {})}

    mixes = (SSM_F32_MIX, SSM_MODEL_MIX, (BF16, F32, F32, BF16))
    timed = (1, 2048, d_inner, n_state, SSM_MODEL_MIX)
    zamba2 = (1, 2048, zamba.d_inner, zamba.ssm_state, SSM_F32_MIX, "f64")
    return {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/ssm_scan.py:49",
        # one library per class of state size (ops.BUILDS)
        "build": tuple(functools.partial(ssm.load, n) for n in ssm.BUILDS),
        "wrapper": ssm.ssm_scan,
        "plain": ssm.ssm_scan_plain,
        "kwargs": {"return_state": True},       # as every prefill calls it
        "library": None,        # no one PyTorch call computes the scan
        "inputs": inputs, "compare": compare, "bound": bound,
        "tolerance": f"|kernel - plain| <= {SSM_TOL} + {SSM_TOL} * |plain| "
                     f"for y and the final state, any input dtypes; a "
                     f"second call bit-identical; a check held to float64: "
                     f"|kernel - exact| <= {SSM_TOL} + {SSM_TOL} * "
                     f"sum_n |h_n C_n| for y, {SSM_TOL} + {SSM_TOL} * "
                     f"|exact| for the state",
        "describe": describe,
        # (B, S, D, N, dtypes) of every prefill and forward of the SSM serve
        # phases; the first is the timed one.  serve_ssm_f32's oracle runs a
        # forward at every length from the prompt's to the prompt's plus
        # F32_NEW - 1, and the engine's prefill at the prompt's.
        "main_shapes": (
            *((1, s, d_inner, n_state, SSM_MODEL_MIX)
              for s in sorted(set(SERVE_PROMPTS), reverse=True)),
            *((2, s, d_inner, n_state, SSM_MODEL_MIX) for s in sorted(
                {s for s in SERVE_PROMPTS if SERVE_PROMPTS.count(s) > 1})),
            *((1, s + d, d_inner, n_state, SSM_F32_MIX) for s in F32_PROMPTS
              for d in range(F32_NEW)),
        ),
        # the serving shape, then zamba2-7b's scan (d_inner 7168, N 64, all
        # f32) for information, on the inputs of its check below: no path
        # of the port runs it yet
        "timed": (timed, zamba2),
        # the JAX sweep (tests/test_kernels.py), ragged S and D; N that is
        # no multiple of a channel's lanes, S of 1 and of no whole chunk or
        # group, D of no whole CTA, B = 2 at the serving width; N up to 64
        # (the second build); each all-f32, with the model's mix and with
        # another mix.  Then channels of long memory, the last at zamba2's
        # width, and zamba2's width with the default inputs, held to float64.
        "sweep": (
            *((b, s, d, n, mix)
              for b, s, d, n in ((1, 64, 32, 8), (2, 128, 64, 16),
                                 (1, 96, 48, 4), (1, 77, 100, 16),
                                 (2, 300, 40, 5), (1, 300, 1000, 16),
                                 (1, 300, 100, 3), (2, 17, 40, 5),
                                 (1, 1, 70, 12), (2, 300, d_inner, 16),
                                 (1, 300, 100, 32), (2, 17, 40, 33),
                                 (1, 77, 100, 64), (2, 1, 70, 64))
              for mix in mixes),
            *((1, 2048, 1024, n_state, mix, "long") for mix in mixes),
            (1, 2048, zamba.d_inner, zamba.ssm_state, SSM_F32_MIX, "long"),
            zamba2),
    }


SORT_ROWS, SORT_N = 4, 1 << 18     # benchmarks/bench_kernels.py:51-58
# the JAX test sweep (tests/test_kernels.py), run by the sort phase
SORT_TEST_SHAPES = ((1, 64), (4, 100), (2, 256), (3, 17))
I32 = torch.int32


def _sort_keys(shape, gen):
    """Keys of ``shape`` = (rows, n, dtype, kind): "bench" uniform in [0,
    2^30) as benchmarks/bench_kernels.py draws them, "random" normal (f32)
    or uniform in [-500, 500) (int32) as tests/test_kernels.py does, "ties"
    from 5 values, "signed_zeros" -0.0 and +0.0 among ties, "max" the
    dtype's largest value (the pad's) in a quarter of the places."""
    rows, n, dtype, kind = shape

    def ints(lo, hi):
        return torch.randint(lo, hi, (rows, n), generator=gen,
                             device="cuda").to(dtype)
    if kind == "bench":
        return ints(0, 1 << 30)
    if kind == "ties":
        return ints(-2, 3)
    if kind == "signed_zeros":
        return ints(0, 3) * torch.where(ints(0, 2) > 0, -1.0, 1.0).to(dtype)
    keys = (torch.randn(rows, n, generator=gen, device="cuda").to(dtype)
            if dtype == F32 else ints(-500, 500))
    if kind == "max":
        info = torch.finfo if dtype == F32 else torch.iinfo
        keys = torch.where(ints(0, 4) == 0, info(dtype).max, keys)
    return keys


def _check_sorted(keys, ks, ps):
    """Keys equal the stable oracle's; each payload entry regathers its key,
    except where the pad tied with a key of the dtype's largest value and
    was kept (payload -1: the key there is that value)."""
    from repro_torch.kernels.bitonic_sort.ref import sort_ref
    kr, _ = sort_ref(keys, ps)
    pad = ps < 0
    got = torch.take_along_dim(keys, ps.clamp(min=0).long(), -1)
    info = torch.finfo if keys.is_floating_point() else torch.iinfo
    return bool(torch.equal(ks, kr) and torch.equal(got[~pad], ks[~pad])
                and bool((ks[pad] == info(keys.dtype).max).all()))


def _sort_library(keys):
    """torch.sort and its indices as the payload (a yardstick only)."""
    ks, order = torch.sort(keys, dim=-1)
    return ks, order.to(torch.int32)


def _bitonic_spec():
    from repro_torch.kernels.bitonic_sort import ops as bs

    def compare(out, ref, args, yardstick=False, shape=()):
        """Kernel against plain: keys (as bits) and payloads equal.  Both,
        and the library yardstick, against the oracle (_check_sorted)."""
        (ks, ps), (kp, pp) = out, ref
        ok = _check_sorted(args[0], ks, ps)
        if not yardstick:
            bits = (lambda t: t.view(I32)) if ks.dtype == F32 else (
                lambda t: t)
            ok = ok and torch.equal(bits(ks), bits(kp)) and torch.equal(ps,
                                                                        pp)
        err = float((ks.double() - kp.double()).abs().max()) if ks.numel() \
            else 0.0
        return err, ok, {}

    def bound(shape):
        """Bytes: keys and payloads read and written once.  Operations: a
        compare and two selects per compare-exchange of the padded rows'
        network, at the CUDA cores' 67 T a second."""
        rows, n, _, _ = shape
        m = 1 << max(n - 1, 0).bit_length()
        stages = m.bit_length() * (m.bit_length() - 1) // 2
        nbytes = rows * n * (4 + 4) * 2
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = 3 * rows * (m // 2) * stages / H100_F32_FLOPS * 1e3
        return max(by_ops, by_bytes), \
            "operations" if by_ops >= by_bytes else "bytes"

    def describe(shape):
        rows, n, dtype, kind = shape
        return {"rows": rows, "n": n,
                "dtype": str(dtype).removeprefix("torch."), "keys": kind}

    c, regs = bs.CHUNK, 1 << bs.REG_BITS
    return {
        "name": "bitonic_sort",
        "route": "cuda",
        "source": "src/repro_torch/kernels/bitonic_sort/csrc/bitonic_sort.cu",
        "replaces": "src/repro/kernels/bitonic_sort/bitonic_sort.py:50",
        "build": bs.load,
        "wrapper": bs.bitonic_sort,
        "plain": bs.bitonic_sort_plain,
        "library": _sort_library,
        "inputs": lambda shape, gen: (_sort_keys(shape, gen),),
        "compare": compare, "bound": bound,
        "tolerance": "bit-exact against the plain version (keys as bits, "
                     "payloads); keys equal the stable oracle's",
        "describe": describe,
        # the benchmark's rows, which the sort phase sorts (timed), then
        # the same rows of float32 keys
        "main_shapes": ((SORT_ROWS, SORT_N, I32, "bench"),
                        (SORT_ROWS, SORT_N, F32, "random")),
        "timed": ((SORT_ROWS, SORT_N, I32, "bench"),
                  (SORT_ROWS, SORT_N, F32, "random")),
        # the JAX test sweep, rows about a thread's registers, a warp's and
        # a chunk, rows of 2, 3 and 15 passes
        "sweep": (
            *((r, n, dt, "random") for r, n in (
                *SORT_TEST_SHAPES, (2, regs - 1), (2, regs + 1),
                (1, 32 * regs), (3, 32 * regs + 1), (1, c - 1), (1, c),
                (2, c + 1), (3, 4 * c - 5), (1, 1 << 20), (1, 1 << 22),
                (64, 1000)) for dt in (I32, F32)),
            *((4, 5000, dt, kind) for dt in (I32, F32)
              for kind in ("ties", "max")),
            (2, 3000, F32, "signed_zeros")),
    }


def kernel_specs():
    return [_radix_spec(), _attention_spec(), _ssm_spec(), _bitonic_spec()]


def phase_build(specs):
    from repro_torch.kernels import _nvcc
    errors = []

    def build(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    # a spec's "build" is one callable or a tuple of them (one per library)
    builds = [fn for s in specs for fn in (
        s["build"] if isinstance(s["build"], tuple) else (s["build"],))]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(fn,)) for fn in builds]
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
    """Each kernel against its plain version at every main-path shape and
    across the sweep, then timed at the first main-path shape (and at its
    spec's "timed" shapes) beside its plain version and its library
    yardstick."""
    records = {}
    for spec in specs:
        checks, max_err = [], 0
        shapes = [(s, True) for s in spec["main_shapes"]] + [
            (s, False) for s in spec["sweep"]]
        kw = spec.get("kwargs", {})
        for shape, main_path in shapes:
            args = spec["inputs"](shape, gen)
            out = spec["wrapper"](*args, **kw)
            ref = spec["plain"](*args, **kw)
            sync()
            err, ok, info = spec["compare"](out, ref, args, shape=shape)
            max_err = max(max_err, err)
            checks.append({**spec["describe"](shape), "main_path": main_path,
                           "max_abs_err": err, **info})
            if not ok:
                raise AssertionError(f"{spec['name']} disagrees with its "
                                     f"plain version at {shape}: max abs "
                                     f"err {err}")
            del args, out, ref
        # the first main-path shape goes into the kernel summary line;
        # "timed" names more shapes to time (their numbers go to this line)
        timings = [_time_kernel(spec, shape, gen, kw) for shape in
                   spec.get("timed", spec["main_shapes"][:1])]
        t = timings[0]
        records[spec["name"]] = {
            "name": spec["name"], "route": spec["route"],
            "source": spec["source"], "replaces": spec["replaces"],
            "launches": 0, "max_abs_err": max_err, "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"]}
        emit("kernels", name=spec["name"], checks=checks, **t,
             timed=timings[1:], tolerance=spec["tolerance"])
    return records


def _time_kernel(spec, shape, gen, kw) -> dict:
    """The kernel's time at ``shape`` beside its bound, its plain version's
    and its library yardstick's, on inputs to which the kernel and the
    yardstick are first held as a check holds them."""
    args = spec["inputs"](shape, gen)
    err, ok, _ = spec["compare"](spec["wrapper"](*args, **kw),
                                 spec["plain"](*args, **kw), args,
                                 shape=shape)
    if not ok:
        raise AssertionError(f"{spec['name']} disagrees with its plain "
                             f"version at the timed {shape}: max abs err "
                             f"{err}")
    lib_err = library_ms = None
    if spec["library"] is not None:
        lib_err, lib_ok, _ = spec["compare"](spec["library"](*args),
                                             spec["plain"](*args), args,
                                             yardstick=True)
        if not lib_ok:
            raise AssertionError(f"{spec['name']}: library yardstick "
                                 f"differs by {lib_err}")
        library_ms = time_ms(lambda: spec["library"](*args))
    ms = time_ms(lambda: spec["wrapper"](*args, **kw))
    plain_ms = time_ms(lambda: spec["plain"](*args, **kw), reps=5, warmup=1)
    bound_ms, bound_by = spec["bound"](shape)
    return {"kernel_ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err, "shape": spec["describe"](shape)}


class MainPath:
    """Zero every kernel's launch count before a main-path phase; after it,
    fail unless each kernel of ``names`` (the ones the phase's path runs)
    launched, and add the counts to the kernel records."""

    def __init__(self, specs, records, names):
        self.specs, self.records, self.names = specs, records, names

    def __enter__(self):
        for s in self.specs:
            s["wrapper"].launches = 0
        return self

    def counts(self) -> dict:
        return {s["name"]: s["wrapper"].launches for s in self.specs}

    def __exit__(self, exc_type, *_):
        if exc_type is not None:
            return False
        counts = self.counts()
        for name in self.names:
            if counts[name] <= 0:
                raise AssertionError(f"{name} never launched on the main path")
        for name, n in counts.items():
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


# ---------------------------------------------------------------------------
# serving: qwen3-8b and falcon-mamba-7b at their published widths on one card
# ---------------------------------------------------------------------------
def serve_model(cfg):
    """Random weights for ``cfg`` drawn on the card from a seeded generator,
    one tensor at a time (no f32 copy of the whole model)."""
    from repro_torch.models import get_model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return get_model(cfg).init(gen, cfg)


def _check_tokens(cfg, reqs, out, act):
    for r in reqs:
        t = out.get(r.uid)
        if t is None or len(t) != r.max_new_tokens or \
                t.min() < 0 or t.max() >= cfg.vocab_size:
            raise AssertionError(f"{act}: request {r.uid} gave {t!r}")


def phase_serve(cfg, params, devices):
    """Both acts of python -m repro_torch.serve_lm at ``cfg``'s widths.
    Returns the phase's record, the continuous engine and the requests."""
    from repro_torch.serve_lm import (act_continuous, act_static,
                                      make_requests)
    reqs = make_requests(cfg, SERVE_PROMPTS, SERVE_BUDGETS)
    tokens = sum(r.max_new_tokens for r in reqs)
    kw = dict(max_batch=SERVE_MAX_BATCH, max_seq=SERVE_MAX_SEQ,
              etl_rows=PIPE_ROWS)
    (static, rep1), s1 = wall(lambda: act_static(cfg, params, reqs, devices,
                                                 **kw))
    _check_tokens(cfg, reqs, static, "act 1")
    (cont, rep2, engine, asc), s2 = wall(
        lambda: act_continuous(cfg, params, reqs, devices, **kw))
    _check_tokens(cfg, reqs, cont, "act 2")
    # bf16 products at different batch sizes need not round alike:
    # reported, not asserted
    agree = sum(int((static[r.uid] == cont[r.uid]).sum()) for r in reqs)
    # act 1 prefills each length group in batches of max_batch, act 2 each
    # request alone
    prefills = sum(-(-SERVE_PROMPTS.count(n) // SERVE_MAX_BATCH)
                   for n in set(SERVE_PROMPTS)) + len(reqs)
    return {
        "requests": len(reqs), "prompt_lengths": SERVE_PROMPTS,
        "max_new_tokens": SERVE_BUDGETS, "generated_tokens": tokens,
        "prefills": prefills,
        "act1_static": {"wall_s": s1, "makespan_s": rep1.makespan,
                        "tokens_per_s": tokens / s1},
        "act2_continuous": {
            "wall_s": s2, "makespan_s": rep2.makespan,
            "tokens_per_s": tokens / s2,
            "decode_rounds": engine.metrics.get("serve_decode_steps"),
            "pipelines": sorted({e.pipeline for e in rep2.trace
                                 if e.kind == "dispatch"}),
            "telemetry_events": sum(e.kind == "telemetry"
                                    for e in rep2.trace),
            "autoscale_actions": len(asc.actions)},
        "tokens_equal_between_acts": f"{agree}/{tokens}",
    }, engine, reqs


def serve_timings(engine, reqs):
    """Prefill ms per prompt length (median of 3), decode ms per round with
    all SERVE_MAX_BATCH slots live (median of 10 after 2), and a profile of
    one 2048-token prefill."""
    from repro_torch.serve import Request
    prefill_ms = {}
    for n in sorted(set(SERVE_PROMPTS)):
        r = next(r for r in reqs if len(r.prompt) == n)
        prefill_ms[n] = statistics.median(
            wall(lambda: engine.prefill_request(r))[1] * 1e3
            for _ in range(3))
    for i in range(SERVE_MAX_BATCH):
        engine.insert(engine.prefill_request(Request(
            prompt=reqs[i].prompt[:512], max_new_tokens=64, uid=1000 + i)))
    if engine.slots_active != SERVE_MAX_BATCH:
        raise AssertionError(f"{engine.slots_active} live slots")
    rounds = [wall(engine.decode_round)[1] * 1e3 for _ in range(12)]
    longest = next(r for r in reqs if len(r.prompt) == max(SERVE_PROMPTS))
    return {"prefill_ms": prefill_ms,
            "decode_ms_per_round": statistics.median(rounds[2:]),
            "decode_live_slots": SERVE_MAX_BATCH,
            "profile_prefill_2048": profile(
                lambda: engine.prefill_request(longest))}


def run_serve(arch, specs, records, kernels):
    """``arch`` at its published widths in bf16 through phase_serve under
    MainPath(``kernels``), then its timings.  Returns the phase's record
    and the launch counts of the main-path run; frees the weights."""
    from repro_torch.configs import get_config
    from repro_torch.core import logical_devices
    from repro_torch.models.transformer import param_count
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config(arch)
    free_device_memory()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    params, init_s = wall(lambda: serve_model(cfg))
    weights_gb = sum(p.numel() * p.element_size()
                     for p in params.parameters()) / 1e9
    # first-use costs (cuBLAS handles, the allocator) before the count
    ServeEngine(cfg, params, max_batch=1, max_seq=128).run_requests(
        [Request(prompt=np.arange(64, dtype=np.int32), max_new_tokens=2)])
    with MainPath(specs, records, kernels) as mp:
        res, engine, reqs = phase_serve(cfg, params,
                                        logical_devices(N_RANKS, "cuda:0"))
    counts = mp.counts()
    res.update(serve_timings(engine, reqs))
    res.update(arch=arch, n_layers=cfg.n_layers,
               param_count=param_count(params), weights_gb=weights_gb,
               init_s=init_s, launches=counts, allocated_gb_at_start=start_gb,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return res, counts


def free_device_memory():
    """Drop what an earlier phase left: the scheduler's tasks, closures and
    threads hold the engines, and so the weights, in reference cycles that
    only the cycle collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_f32(arch):
    """``arch``'s widths, 2 layers, float32: the continuous engine (prefill
    through the kernels, plain decode) against greedy_reference (a full
    forward through the kernels per token), token for token."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.serve import ContinuousEngine, greedy_reference
    from repro_torch.serve_lm import make_requests
    # full f32 products and convolutions on both sides of the comparison:
    # TF32 would keep about three digits and let near-tied logits flip
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    free_device_memory()
    params = serve_model(cfg)
    reqs = make_requests(cfg, F32_PROMPTS, [F32_NEW] * len(F32_PROMPTS),
                         seed=1)
    out = ContinuousEngine(cfg, params, max_batch=2, max_seq=512).run(reqs)
    for r in reqs:
        ref = greedy_reference(cfg, params, r.prompt, r.max_new_tokens)
        if not np.array_equal(out[r.uid], ref):
            raise AssertionError(f"f32 request {r.uid}: {out[r.uid]} != "
                                 f"oracle {ref}")
    return {"arch": arch, "layers": 2, "dtype": "float32",
            "prompt_lengths": F32_PROMPTS, "max_new_tokens": F32_NEW,
            "tokens_equal_oracle": True, "tf32": False}


def phase_sort(gen):
    """bitonic_sort's path in the JAX package: the benchmark's row sort and
    the test sweep's rows, through the wrapper, each held to the oracle."""
    from repro_torch.kernels.bitonic_sort.ops import bitonic_sort
    shapes = [(SORT_ROWS, SORT_N, I32, "bench")] + [
        (r, n, dt, "random") for r, n in SORT_TEST_SHAPES
        for dt in (I32, F32)]
    rows = []
    for shape in shapes:
        keys = _sort_keys(shape, gen)
        (ks, ps), s = wall(lambda: bitonic_sort(keys))
        if not _check_sorted(keys, ks, ps):
            raise AssertionError(f"bitonic_sort disagrees with the oracle "
                                 f"at {shape[:3]}")
        rows.append({"rows": shape[0], "n": shape[1],
                     "dtype": str(shape[2]).removeprefix("torch."),
                     "wall_s": s})
    return {"sorts": rows}


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

    radix, attention, scan = ("radix_partition",), ("flash_attention",), \
        ("ssm_scan",)
    with MainPath(specs, records, ("bitonic_sort",)) as mp:
        res = phase_sort(gen)
    emit("sort", launches=mp.counts(), **res)
    comm = build_communicator(logical_devices(N_RANKS, "cuda:0"))
    rng = np.random.default_rng(0)
    with MainPath(specs, records, radix) as mp:
        res = phase_dist(comm, rng)
    emit("dist", launches=mp.counts(), **res)
    # first-use costs of the ETL payloads, before the count and the makespans
    from repro_torch import etl
    etl.warm_up(N_RANKS, "cuda:0")
    with MainPath(specs, records, radix) as mp:
        res = phase_pipeline()
    emit("pipeline", launches=mp.counts(), **res)
    one = build_communicator(logical_devices(1, "cuda:0"))
    with MainPath(specs, records, radix) as mp:
        res = phase_shuffle(one, rng)
    emit("shuffle", launches=mp.counts(), **res)

    res, _ = run_serve(SERVE_ARCH, specs, records, radix + attention)
    emit("serve", **res)
    with MainPath(specs, records, attention) as mp:
        res = phase_serve_f32(SERVE_ARCH)
    emit("serve_f32", launches=mp.counts(), **res)

    res, counts = run_serve(SSM_ARCH, specs, records, radix + scan)
    # every prefill runs the scan once per layer, and nothing else does
    want = res["n_layers"] * res["prefills"]
    if counts["ssm_scan"] != want:
        raise AssertionError(f"ssm_scan launched {counts['ssm_scan']} times "
                             f"for {res['prefills']} prefills of "
                             f"{res['n_layers']} layers ({want})")
    emit("serve_ssm", ssm_scan_launches_per_prefill=res["n_layers"], **res)
    with MainPath(specs, records, scan) as mp:
        res = phase_serve_f32(SSM_ARCH)
    emit("serve_ssm_f32", launches=mp.counts(), **res)

    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
