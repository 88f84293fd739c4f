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
            |plain| of the plain version run in f32, causal or not as the
            main path calls it (whisper's encoder and cross-attention:
            non-causal, Sq != Sk; zamba2's shared block at head dim 112);
            ssm_scan's y and final state within 1e-5 + 1e-5 * |plain|,
            whatever the inputs' dtypes, and a second call bit-identical
            (at zamba2's width, N 64, and at its Mamba2 calls: held to the
            float64 scan instead); with the state in bf16 (ssm_scan_dtype
            "bfloat16") at serve_ssm_bf16's shapes, the sweep, the
            long-memory inputs and zamba2's call: the state bit for bit, y
            within 1e-5 + 1e-5 * sum_n |h_n C_n|, and at long memory y
            nearer the bf16-state plain version than the f32 one; timed in
            both modes;
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
  process   ProcessExecutor: 2 worker processes of 2 ranks each, both on
            cuda:0 (a CUDA context each beside this one): the ETL pipelines
            on the process backend under both policies (makespans beside the
            thread backend's) and merge_all across both workers, a sort task
            spanning both workers at 17.5 million rows a part (35 million in
            all, verify_kernel on) and a join task at 2 million rows a side a
            part, both held to numpy, then one worker SIGKILLed under a
            2-rank task, which must finish on the survivor after a retry; no
            worker may outlive shutdown().  radix_partition launches in the
            workers, out of this process's count: each worker's count is
            read by a task spanning both (etl.radix_launches), and each
            worker must have launched it
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
  serve_ssm_bf16  serve_ssm's weights with ssm_scan_dtype "bfloat16": the
            continuous engine over the same requests, ssm_scan twice a layer
            a prefill (y from the bf16 state, the f32 state for decode),
            prefill and decode times beside serve_ssm's; each prompt
            length's prefill states bit-equal to the f32 mode's on the same
            scan inputs
  serve_ssm_f32  falcon-mamba-7b's widths with 2 layers in float32 (TF32
            off for matmuls and cuDNN): the continuous engine's tokens equal
            the full-forward oracle's
  serve_moe qwen2-moe-a2.7b at its published widths in bf16 (24 layers, 60
            experts top-4, 4 shared; 14.3 B parameters), the same two acts,
            requests and timings as serve; flash_attention launches once
            per layer per prefill; then the share of (token, expert) pairs
            dropped at the published capacity factor 1.25 in one prefill of
            1, 2 (act 1's batch) and 4 x 2048 tokens
  serve_moe_f32  qwen2-moe's widths with 2 layers in float32, the capacity
            factor raised to n_experts / top_k so that no pair drops: the
            continuous engine's tokens equal the full-forward oracle's, 0
            pairs dropped; then one MoE layer at cf 1.25 with T = 2048 and
            8192 tokens drawn around one shared vector, so that pairs drop:
            moe_ffn within 1e-5 of the largest |output| of the dense oracle
            with the same dropped pairs masked out
  serve_llama4  llama4-maverick at its published widths on one superblock
            (a dense layer of d_ff 16384 and an MoE layer of 128 experts,
            18.7 B parameters with the embeddings), bf16: ServeEngine
            serves 4 requests of 512-2048 tokens, 16 new tokens each,
            flash_attention twice a prefill; prefill and decode times
  serve_vlm internvl2-1b at its published widths in bf16 (24 layers, 14/2
            heads: GQA group 7; 0.49 B parameters), the serve requests
            after its 256 stub patch embeddings (zeros), both acts and
            timings as serve
  serve_vlm_f32  its widths with 2 layers in float32: tokens equal the
            full-forward oracle's
  serve_audio  whisper-medium at its published widths in bf16 (24 encoder
            and 24 decoder layers, 16 heads; 0.96 B parameters) on
            Whisper's own decoding traffic: prompts of 4-223 tokens over
            1500 stub frames (zeros), each prompt with its new tokens
            within n_text_ctx 448; flash_attention 72 times a prefill (the
            encoder, the decoder's self- and cross-attention)
  serve_audio_f32  its widths with 2 + 2 layers in float32: tokens equal
            the full-forward oracle's
  serve_hybrid  zamba2-7b whole at its published widths in bf16 (81 Mamba2
            layers, d_inner 7168 in 112 heads, N 64; the shared attention
            block, 32 heads of hd 112, applied 9 times; 6.75 B
            parameters), the same two acts, requests and timings as serve;
            flash_attention 9 times and ssm_scan 81 times a prefill
  serve_hybrid_f32  its widths in float32 at the reduced config's
            structure, two groups of two Mamba2 layers: tokens equal the
            full-forward oracle's
  sort      bitonic_sort's own path, the row sorts of the JAX package's
            benchmark (4 rows of 2^18 int32 keys in [0, 2^30),
            benchmarks/bench_kernels.py) and of its test sweep, through the
            wrapper: keys equal the stable oracle's (its ref.sort_ref),
            payloads regather them
  train_etl the ETL -> train pipeline of python -m repro_torch.train_lm at
            its full preset (qwen3-100m, 12 layers, f32, batch 8 x 256): the
            ETL stage on 4 logical ranks of cuda:0 feeds 40 steps saving
            every 20, the same state goes on to 60; a fresh trainer restores
            step 40 (bit-equal) and trains to 60 (losses within 1e-5
            relative of the uninterrupted run's); the loss falls; then
            radix_partition is held to its plain version at every (n, B)
            the ETL stage called it at
  train_qwen3  qwen3-8b at its published widths in bf16, 4 of its 36 layers,
            5 AdamW steps on one batch of 1 x 2048 tokens: the loss falls,
            step time and peak memory (under 80 GB); the forward and
            backward under remat_mode "dots" (every train phase's) and
            "nothing": ms, peak GB, the backward's matrix products and the
            weight products among them it recomputes (none under "dots");
            then the attention Function's q, k and v gradients bit-equal
            to autograd of the plain path at (1, 2048, 32, 8, 128) bf16
  train_moe qwen2-moe-a2.7b at its published widths in bf16, 4 of its 24
            layers (2.90 B parameters), the same 5 steps: the loss falls,
            step time, peak memory under 80 GB
  train_ssm falcon-mamba-7b at its published widths in bf16, 4 of its 64
            layers, the same 5 steps through ssm_scan under autograd
            (SSMScan): ssm_scan twice a layer a step under remat; then
            SSMScan's gradients bit-equal to autograd of ssm_scan_chunked
            at (1, 2048, 8192, 16) and the backward's transient memory,
            with the state in f32 and in bf16 (chunk 1024)
  train_vlm / train_audio  internvl2-1b (1 x 2048 tokens after 256 patch
            embeddings) and whisper-medium (1500 frames, 448 tokens) at
            their published widths and full depth, bf16, 3 steps: the loss
            falls, step time, peak memory under 80 GB; whisper runs
            FlashAttention's backward for non-causal Sq != Sk
  train_hybrid  zamba2-7b at its published widths in bf16, 18 of its 81
            layers (two groups of 9: the shared block's gradient sums two
            applications), the same 5 steps; then SSMScan's gradients at
            one Mamba2 layer's call (1, 2048, 7168, 64), the state in f32
            and in bf16, and FlashAttention's at (1, 2048, 32, 32, 112)
            bf16, each bit-equal to autograd of its plain path
  train_cpu_gpu  the ci preset, 10 steps from the same parameters and
            batches on cuda:0 (TF32 off) and on the CPU: losses within 1e-4
            relative
  train_task   python -m repro_torch.train_lm's train_task (ci preset) as a
            task on the thread executor with a checkpoint root: it saves
            through comm.checkpoint every 5 steps, its first attempt raises
            after step 12, the retry resumes from step 10 and finishes; the
            session's trace exported by the port's Perfetto export
  train_dist   qwen3-8b at its published widths in bf16, 4 of its 36
            layers, on a (2, 2) mesh of 4 logical ranks of cuda:0
            (make_local_mesh; Trainer(mesh=)), global batch 2 x 2048 (1 x
            2048 a data rank), 5 AdamW steps: the loss falls, peak memory
            under 80 GB, flash_attention 16 times a step (4 layers x 2 data
            ranks x 2 under remat), each rank's bytes of parameters and
            moments its share of each sharded leaf plus the replicated
            ones; the trainer's save of step 5 (unsharded onto the host),
            one more step under the profiler; then the checkpoint restored
            onto (4, 1), (1, 4) and (1, 1) meshes, each restore's
            parameters and moments bit-equal to those saved (compared on
            the card), and one step on (1, 4)
  train_dist_f32  qwen3-8b's widths with 2 layers in float32 (TF32 off):
            the same parameters and batches to a (2, 2) trainer and a
            one-rank trainer, 3 steps: losses within 1e-5 relative
  moe_ep    one qwen2-moe-a2.7b MoE layer at its published widths in f32
            (60 experts top-4, 4 shared; cf 1.25), 2 x 2048 tokens drawn
            around one shared vector so that pairs drop, on a (2, 2) mesh:
            moe_ffn_shardmap within 1e-5 of the largest |output| of
            moe_ffn run on each data shard alone; pairs dropped, ms
  compress  compressed_psum_mean over 4 logical ranks of cuda:0 on
            (4096, 12288) f32 tensors (qwen3-8b's MLP wg gradient): the
            mean within 0.02 of the exact mean (relative to its largest
            magnitude), each rank's x + e_old - e_new equal to its
            dequantised value, a second call fed the errors within the
            same bound; ms and wire bytes against f32
  serve_dist   qwen3-8b whole at its published widths in bf16 (36
            layers, 8.19 B) sharded by shard_model onto a (2, 2) mesh of 4
            logical ranks of cuda:0: make_prefill_step on 4 prompts of 2048
            tokens (2 rows a data rank; a cell of 2080 positions, so that
            the decode steps fit), then 32 greedy steps of
            make_decode_step on its cache blocks; prefill, decode and
            gather ms, peak memory under 80 GB, flash_attention 72 times a
            prefill step (36 layers x 2 data ranks), each rank's bytes of
            parameters, cache and batch equal to the dry run's
            (launch/dryrun.py on meta ranks, run inside the phase) and its
            predicted memory beside the measured peak
  serve_dist_f32  qwen3-8b's widths and qwen2-moe-a2.7b's (moe_impl
            "shardmap", capacity factor n_experts / top_k: no pair drops,
            its cache in the superblock layout), 2 layers each, float32
            (TF32 off), 4 x 2048 tokens and 8 greedy steps on the (2, 2)
            mesh against one rank's prefill and decode_step from the same
            weights: tokens equal, logits within 1e-5 of the largest
            |logit| at every step

The main-path phases (dist, pipeline, shuffle, process, the fourteen
serve phases, sort, the nine train phases and the six distributed ones)
each start with every kernel's launch count at 0 and fail unless each
kernel that the phase's path runs launched (the bf16 serve phases and
serve_llama4: exactly once per layer per prefill, whisper's decoder layers
twice, zamba2's attention once a group, serve_ssm_bf16's scan twice a
layer; the train phases, remat_mode "dots": once per layer per forward,
twice under remat; train_dist: once per layer per forward
per data rank, twice under remat; serve_dist: once per layer per data
rank a prefill step, none in decode; moe_ep and compress run no kernel).
Then
come the kernel summary line, the card's name and power limit as
nvidia-smi gives them, and last
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
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DIST_ROWS = 35_000_000          # the paper's dataframe size
N_RANKS = 4
PIPE_ROWS = 2_000_000           # rows per ETL task in the pipeline phase
PROC_WORKERS, PROC_RANKS = 2, 2     # process phase: workers, ranks a worker
PROC_SORT_ROWS = DIST_ROWS // PROC_WORKERS  # rows a part of the spanning sort
PROC_JOIN_ROWS = 2_000_000      # rows a side a part of the spanning join
SHUFFLE_BUCKETS = 8             # radix_bucket's buckets in the shuffle phase
SERVE_ARCH = "qwen3-8b"
SSM_ARCH = "falcon-mamba-7b"
SERVE_PROMPTS = [2048, 2048, 1024, 1024, 512, 512, 1536, 768]
SERVE_BUDGETS = [16, 32] * 4    # max_new_tokens of each serve request
SERVE_MAX_BATCH, SERVE_MAX_SEQ = 4, 4096
F32_PROMPTS, F32_NEW = [300, 77, 129], 8      # the f32 token check
MOE_ARCH = "qwen2-moe-a2.7b"
LLAMA4_ARCH = "llama4-maverick-400b-a17b"
MOE_DROP_BATCHES, MOE_DROP_SEQ = (1, 2, 4), 2048  # prefills whose drops count
MOE_ORACLE_TOKENS = (2048, 8192)    # moe_ffn against the masked dense oracle
MOE_ORACLE_RTOL = 1e-5          # of the oracle output's largest magnitude
LLAMA4_PROMPTS, LLAMA4_NEW = [512, 1024, 1536, 2048], 16
LLAMA4_DECODE_FROM = 512        # the prompt length its decode rounds follow
TRAIN_MOE_LAYERS = 4
CARD = "cuda:0"                 # the device of the train and MoE phases
TRAIN_ETL_STEPS, TRAIN_ETL_SAVED, TRAIN_ETL_EVERY = 60, 40, 20
TRAIN_RESUME_RTOL = 1e-5        # resumed against uninterrupted losses
TRAIN_QWEN3_LAYERS, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5
VLM_ARCH, AUDIO_ARCH = "internvl2-1b", "whisper-medium"
HYBRID_ARCH = "zamba2-7b"
# the hybrid f32 token check: the published widths at the reduced config's
# structure, two groups of two Mamba2 layers (the shared block twice, each
# application its own KV slot)
HYBRID_F32 = {"n_layers": 4, "shared_attn_period": 2}
TRAIN_HYBRID_LAYERS = 18        # two groups of the published period 9
LONG_STEP_MS = 3000             # split_step profiles no longer step
ONCE_STEP_MS = 1000             # and times a step longer than this once
# Whisper's own decoding: the 4 start-of-transcript tokens, alone or after
# a previous-text prompt (at most n_text_ctx // 2 = 224 tokens in all), and
# a prompt with its new tokens within n_text_ctx = 448 (arXiv:2212.04356;
# openai/whisper decoding.py)
AUDIO_TEXT_CTX = 448
AUDIO_PROMPTS = [4, 4, 4, 4, 100, 100, 223, 223]
AUDIO_BUDGETS = [128, 64] * 4
TRAIN_SSM_LAYERS, TRAIN_FULL_STEPS = 4, 3
TRAIN_CPU_GPU_STEPS, TRAIN_CPU_GPU_RTOL = 10, 1e-4
TASK_STEPS, TASK_CKPT_EVERY, TASK_FAIL_AT = 20, 5, 12
DIST_GRID, DIST_BATCH = (2, 2), 2         # train_dist's mesh and rows
DIST_RESTORE_GRIDS = ((4, 1), (1, 4), (1, 1))
DIST_F32_LAYERS, DIST_F32_STEPS, DIST_F32_RTOL = 2, 3, 1e-5
EP_TOKENS, EP_RTOL = 2 * 2048, 1e-5         # moe_ep on DIST_GRID
COMPRESS_SHAPE, COMPRESS_RTOL = (4096, 12288), 0.02
# serve_dist: prompts of 2048 tokens a row, 2 rows a data rank, in a cell
# of 2048 + 32 positions, so that the 32 decode steps fit its cache
SERVE_DIST_ROWS, SERVE_DIST_PROMPT, SERVE_DIST_NEW = 4, 2048, 32
SERVE_DIST_PREFILLS = 3                     # timed prefill steps
SERVE_DIST_F32_NEW, SERVE_DIST_F32_RTOL = 8, 1e-5
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
    (summed; the port runs on one stream), each port kernel's share, the
    device's idle share of the profiled wall time, and the number of
    device kernels the run launched.  Only the device is traced: host ops
    would add events to read back and nothing to these numbers."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    sync()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, launched = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
            launched += 1
    busy = sum(by_name.values())
    if not busy:
        return {"profiled_wall_ms": wall_ms, "device_ms": "not measured"}
    out = {"profiled_wall_ms": wall_ms, "device_ms": busy,
           "idle_share": 1 - busy / wall_ms, "device_kernels": launched}
    for kernel, names in KERNEL_NAMES.items():
        out[f"{kernel}_ms"] = sum(v for k, v in by_name.items()
                                  if any(r in k for r in names))
        out[f"{kernel}_share"] = out[f"{kernel}_ms"] / busy
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["top"] = [[k[:80], v] for k, v in top]
    return out


def range_device_ms(fn, name: str) -> dict:
    """One run of ``fn`` under torch.profiler, host and device traced: the
    number of profiler ranges called ``name`` it opened and the device time
    of the kernels launched inside them (each kernel's duration, found by
    its launch's correlation with a host op inside the range, summed over
    the ranges).  A separate run from :func:`profile`'s, whose idle share
    host tracing would raise."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        sync()

    def kernel_us(e):
        # the range's own device-side annotation is not a kernel
        return sum(k.duration for k in e.kernels if k.name != name) + \
            sum(kernel_us(c) for c in e.cpu_children)
    ranges = [e for e in prof.events()
              if e.name == name and e.device_type ==
              torch.autograd.DeviceType.CPU]
    total = sum(kernel_us(e) for e in ranges) / 1e3
    return {"count": len(ranges),
            "device_ms": total if total else "not measured",
            "timed_by": "torch.profiler: the device kernels launched inside "
                        f"the {name!r} ranges of one more run"}


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
        # process: each worker's part of the spanning sort and join, and
        # an ETL task's pack on one rank of a worker
        (PROC_SORT_ROWS, PROC_WORKERS),
        (PROC_JOIN_ROWS, PROC_WORKERS),
        (capacity(PIPE_ROWS, 1), 2),
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


def _attention_library(q, k, v, causal=True):
    """scaled_dot_product_attention on the same inputs (a yardstick only;
    the port never calls it)."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True)
    return out.transpose(1, 2)


def attention_shapes(cfg, b, s, dtype, prefix=0):
    """The (B, H, K, Sq, Sk, hd, dtype, causal) of every kernel call one
    prefill or forward of ``cfg`` makes over ``s`` tokens after ``prefix``
    rows (a VLM's patches): the decoder's causal self-attention, and an
    encoder-decoder's encoder over its frames and cross-attention from the
    tokens to them (both non-causal)."""
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = prefix + s
    out = [(b, h, kh, n, n, hd, dtype, True)]
    if cfg.family == "audio":
        f = cfg.n_encoder_frames
        out += [(b, h, h, f, f, hd, dtype, False),
                (b, h, h, n, f, hd, dtype, False)]
    return out


def _attention_spec():
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.train_lm import model_for
    vlm, audio = get_config(VLM_ARCH), get_config(AUDIO_ARCH)
    zamba = get_config(HYBRID_ARCH)

    def inputs(shape, gen):
        b, h, kh, sq, sk, hd, dtype, _ = shape
        return tuple(
            torch.randn(dims, generator=gen, device="cuda").to(dtype)
            for dims in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd)))

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
            ref32 = fa.flash_attention_plain(*(a.float() for a in args),
                                             causal=shape[-1])
            diff32 = (out.float() - ref32).abs()
            info["max_abs_err_vs_f32_plain"] = float(diff32.max())
            ok = ok and bool(
                (diff32 <= BF16_F32_ATOL + tol * ref32.abs()).all())
        return float(diff.max()), ok, info

    def bound(shape):
        """4 hd FLOPs an unmasked (row, col) pair a head: S (S + 1) / 2
        pairs causal, Sq Sk not; bytes: q, o, k, v once."""
        b, h, kh, sq, sk, hd, dtype, causal = shape
        pairs = sq * (sq + 1) / 2 if causal else sq * sk
        flops = 4 * hd * h * b * pairs
        size = 2 if dtype == torch.bfloat16 else 4
        nbytes = size * hd * b * (2 * h * sq + 2 * kh * sk)
        by_ops = flops / H100_BF16_FLOPS * 1e3
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return max(by_ops, by_bytes), \
            "operations" if by_ops >= by_bytes else "bytes"

    def describe(shape):
        b, h, kh, sq, sk, hd, dtype, causal = shape
        return {"B": b, "H": h, "K": kh, "Sq": sq, "Sk": sk, "hd": hd,
                "dtype": str(dtype).removeprefix("torch."),
                "causal": causal}

    def serve_shapes(cfg, prompts, prefix=0):
        """Every prefill of a serve phase: act 2's of each prompt alone,
        act 1's of each length group in batches of SERVE_MAX_BATCH."""
        return [sh for n in sorted(set(prompts), reverse=True)
                for b in sorted({1, *(min(SERVE_MAX_BATCH, prompts.count(n)
                                          - i) for i in range(
                                  0, prompts.count(n), SERVE_MAX_BATCH))})
                for sh in attention_shapes(cfg, b, n, bf16, prefix)]

    def f32_shapes(cfg, prefix=0):
        """The f32 serve phases: the oracle's forward at every length from
        the prompt's to the prompt's plus F32_NEW - 1, and the engine's
        prefill at the prompt's."""
        return [sh for n in F32_PROMPTS for d in range(F32_NEW)
                for sh in attention_shapes(cfg, 1, n + d, f32, prefix)]

    bf16, f32 = torch.bfloat16, torch.float32
    qwen3 = (32, 8, 128)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:59",
        "build": fa.load,
        "wrapper": fa.flash_attention,
        "shape_kwargs": lambda shape: {"causal": shape[-1]},
        "plain": fa.flash_attention_plain,
        "library": _attention_library,
        "inputs": inputs, "compare": compare, "bound": bound,
        "tolerance": f"|kernel - plain| <= tol + tol * |plain|, tol "
                     f"{F32_TOL} (f32), {BF16_TOL} (bf16); a bf16 kernel "
                     f"also |kernel - plain in f32| <= {BF16_F32_ATOL} + "
                     f"{BF16_TOL} * |plain in f32|",
        "describe": describe,
        # (B, H, K, Sq, Sk, hd, dtype, causal) of every prefill and forward
        # of the serve and train phases; the first is the timed one.
        "main_shapes": tuple(dict.fromkeys((
            *((b, *qwen3[:2], s, s, qwen3[2], bf16, True)
              for b, s in ((1, s) for s in sorted(set(SERVE_PROMPTS),
                                                   reverse=True))),
            *((2, *qwen3[:2], s, s, qwen3[2], bf16, True) for s in sorted(
                {s for s in SERVE_PROMPTS if SERVE_PROMPTS.count(s) > 1})),
            *((1, *qwen3[:2], s + d, s + d, qwen3[2], f32, True)
              for s in F32_PROMPTS for d in range(F32_NEW)),
            # the train phases' f32 forwards: the full preset (train_etl)
            # and the ci preset (train_cpu_gpu, train_task); train_qwen3's
            # is the first shape
            *((sh.global_batch, c.n_heads, c.n_kv_heads, sh.seq_len,
               sh.seq_len, c.head_dim, f32, True)
              for c, sh, _ in map(model_for, ("full", "ci"))),
            # qwen2-moe (16 heads, 16 kv heads): serve_moe's prefills as
            # serve's, its drop counts' B x 2048 prefills and train_moe's
            # forward (1 x 2048); serve_moe_f32's as serve_f32's
            *((1, 16, 16, s, s, 128, bf16, True)
              for s in sorted(set(SERVE_PROMPTS), reverse=True)),
            *((2, 16, 16, s, s, 128, bf16, True) for s in sorted(
                {s for s in SERVE_PROMPTS if SERVE_PROMPTS.count(s) > 1})),
            *((b, 16, 16, MOE_DROP_SEQ, MOE_DROP_SEQ, 128, bf16, True)
              for b in MOE_DROP_BATCHES if b > 2),
            *((1, 16, 16, s + d, s + d, 128, f32, True) for s in F32_PROMPTS
              for d in range(F32_NEW)),
            # llama4-maverick (40 heads, 8 kv heads): serve_llama4's
            # prefills, and the 4 x 512 one its decode rounds start from
            *((1, 40, 8, s, s, 128, bf16, True) for s in LLAMA4_PROMPTS),
            (SERVE_MAX_BATCH, 40, 8, LLAMA4_DECODE_FROM, LLAMA4_DECODE_FROM,
             128, bf16, True),
            # internvl2-1b (14 heads, 2 kv heads: GQA group 7, hd 64; its
            # n_patches rows before the tokens): serve_vlm's prefills,
            # serve_vlm_f32's, train_vlm's forward
            *serve_shapes(vlm, SERVE_PROMPTS, vlm.n_patches),
            *f32_shapes(vlm, vlm.n_patches),
            *attention_shapes(vlm, 1, TRAIN_SEQ, bf16, vlm.n_patches),
            # whisper-medium (16 heads, hd 64): the encoder over 1500
            # frames, the decoder's self-attention and its cross-attention
            # (Sq != Sk, non-causal) of serve_audio's prefills,
            # serve_audio_f32's and train_audio's forward
            *serve_shapes(audio, AUDIO_PROMPTS),
            *f32_shapes(audio),
            *attention_shapes(audio, 1, AUDIO_TEXT_CTX, bf16),
            # zamba2-7b's shared block (32 heads, MHA, hd 112 on the hd-128
            # tiles in bf16): serve_hybrid's prefills, serve_hybrid_f32's
            # (f32) and train_hybrid's forward (1 x 2048, among the first)
            *serve_shapes(zamba, SERVE_PROMPTS),
            *f32_shapes(zamba),
            # serve_dist: each (data, model) rank's prefill of its
            # SERVE_DIST_ROWS / DIST_GRID[0] rows on its H / DIST_GRID[1]
            # heads (bf16, and serve_dist_f32's qwen3-8b and qwen2-moe in
            # f32), the same rows on all the heads (serve_dist_f32's
            # tensor_parallel=False) and one rank's f32 prefill of all the
            # rows
            *((b, h // m, kh // m, SERVE_DIST_PROMPT, SERVE_DIST_PROMPT,
               128, dtype, True)
              for h, kh, dtype in ((*qwen3[:2], bf16), (*qwen3[:2], f32),
                                   (16, 16, f32))
              for b, m in ((SERVE_DIST_ROWS // DIST_GRID[0], DIST_GRID[1]),
                           (SERVE_DIST_ROWS // DIST_GRID[0], 1),
                           (SERVE_DIST_ROWS, 1))
              if dtype == f32 or m > 1),
        ))),
        # the dense prefill's shape (the summary line's), then a 2048-token
        # prefill of qwen2-moe and of llama4-maverick, internvl2-1b's
        # train forward (GQA group 7), whisper's encoder and its train
        # forward's cross-attention (non-causal, all Sq Sk pairs), and
        # zamba2's shared block at 2048 tokens (hd 112)
        "timed": ((1, *qwen3[:2], 2048, 2048, qwen3[2], bf16, True),
                  (1, 16, 16, 2048, 2048, 128, bf16, True),
                  (1, 40, 8, 2048, 2048, 128, bf16, True),
                  *attention_shapes(vlm, 1, TRAIN_SEQ, bf16, vlm.n_patches),
                  *attention_shapes(audio, 1, AUDIO_TEXT_CTX, bf16)[1:],
                  *attention_shapes(zamba, 1, 2048, bf16)),
        "sweep": (
            *((b, h, kh, s, s, hd, dtype, True)
              for b, s, h, kh, hd in ((1, 128, 4, 4, 32), (2, 256, 8, 2, 64),
                                      (1, 130, 8, 8, 32), (2, 384, 6, 3, 128),
                                      (1, 1, 4, 2, 16), (1, 17, 8, 2, 128),
                                      (2, 300, 14, 2, 64), (1, 130, 4, 4, 112),
                                      (2, 63, 8, 2, 112))
              for dtype in (f32, bf16)),
            # hd 112 non-causal, Sq against Sk shorter and longer
            *((1, 8, 8, sq, sk, 112, dtype, False)
              for sq, sk in ((37, 300), (300, 37)) for dtype in (f32, bf16)),
            # non-causal, Sq against Sk shorter, equal and longer, on and
            # off the 128-row tiles
            *((b, h, kh, sq, sk, 64, dtype, False)
              for b, sq, sk, h, kh in ((1, 1, 1500, 16, 16),
                                       (2, 37, 300, 14, 2),
                                       (1, 300, 37, 8, 8),
                                       (2, 129, 129, 16, 16))
              for dtype in (f32, bf16))),
    }


SSM_TOL = 1e-5                  # tests/test_kernels.py's f32 tolerance
F32, BF16 = torch.float32, torch.bfloat16
SSM_MODEL_MIX = (F32, BF16, BF16, BF16)     # dt, x, Bm, Cm in a bf16 model
SSM_F32_MIX = (F32,) * 4
# a shape marked so runs the scan with its state in bf16 (ssm_scan_dtype
# "bfloat16")
BF16_STATE = "bf16state"


def _ssm_state_kwargs(shape) -> dict:
    return {"state_dtype": BF16} if BF16_STATE in shape[5:] else {}


def _ssm_spec():
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import accuracy
    from repro_torch.kernels.ssm_scan import ops as ssm
    cfg = get_config(SSM_ARCH)
    d_inner, n_state, dt_rank = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    zamba = get_config(HYBRID_ARCH)

    def inputs(shape, gen):
        """``accuracy.inputs``: dt = softplus(normal), A = -exp(0.3 normal),
        or with "long" Mamba's own ranges (each channel's dt around a level
        drawn log-uniform in [0.001, 0.1], A = -(1..N)); Bm, Cm column
        slices of one (B, S, dt_rank + 2N) tensor, as the model's x_db
        gives them.  With "mamba2" the call of zamba2's Mamba2 layer: each
        head's dt and A repeated over its 64 channels, x, Bm and Cm slices
        of one (B, S, D + 2N) tensor."""
        b, s, d, n, dtypes = shape[:5]
        kind = next((k for k in ("long", "mamba2") if k in shape[5:]),
                    "softplus")
        return accuracy.inputs(b, s, d, n, dtypes, kind, gen=gen,
                               dt_rank=dt_rank,
                               head_dim=zamba.ssm_head_dim)

    def compare(out, ref, args, yardstick=False, shape=()):
        """Largest absolute difference of y and of the final state, and
        whether every element is within SSM_TOL + SSM_TOL * |plain|: both
        sides compute in f32 from the same values.  A second call must give
        the same bits (no atomics: the sums run in a fixed order).

        A shape marked BF16_STATE (the state in bf16): the final state
        must equal the plain version's bit for bit (the kernel takes its
        decay from the same expf and rounds op by op as the plain version
        does), and y lie within SSM_TOL + SSM_TOL * sum_n |h_n C_n| of the
        plain y (the same f32 products summed in another order;
        ``accuracy.terms_bf16``).  At a long-memory shape the mode must
        show: y nearer the bf16-state plain version than the f32 one.

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
        marks = (shape or ())[5:]
        again = ssm.ssm_scan(*args, return_state=True,
                             **_ssm_state_kwargs(shape or ()))
        same = all(torch.equal(o, a) for o, a in zip(out, again, strict=True))
        # worst_of_tolerance: the largest |kernel - plain| over its bound
        info = {"repeat_bit_identical": same, "worst_of_tolerance": worst}
        if BF16_STATE in marks:
            info["state_bit_equal"] = torch.equal(out[1], ref[1])
            info["y_over_terms_bound"] = accuracy.over_bound(
                out[0], ref[0], accuracy.terms_bf16(*args))
            ok = info["state_bit_equal"] and \
                info["y_over_terms_bound"] <= 1 and same
            if "long" in marks:
                f32 = ssm.ssm_scan_plain(*args)
                info["y_vs_bf16_plain"] = float((out[0] - ref[0]).abs().max())
                info["y_vs_f32_plain"] = float((out[0] - f32).abs().max())
                info["mode_shows"] = \
                    info["y_vs_bf16_plain"] < info["y_vs_f32_plain"]
                ok = ok and info["mode_shows"]
            return err, ok, info
        if "f64" not in marks:
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
            **({"inputs": "mamba2"} if "mamba2" in shape[5:] else {}),
            **({"held_to": "float64"} if "f64" in shape[5:] else {}),
            **({"state": "bfloat16"} if BF16_STATE in shape[5:] else {})}

    mixes = (SSM_F32_MIX, SSM_MODEL_MIX, (BF16, F32, F32, BF16))
    sweep_sizes = ((1, 64, 32, 8), (2, 128, 64, 16), (1, 96, 48, 4),
                   (1, 77, 100, 16), (2, 300, 40, 5), (1, 300, 1000, 16),
                   (1, 300, 100, 3), (2, 17, 40, 5), (1, 1, 70, 12),
                   (2, 300, d_inner, 16), (1, 300, 100, 32), (2, 17, 40, 33),
                   (1, 77, 100, 64), (2, 1, 70, 64))
    long_shapes = (*((1, 2048, 1024, n_state, mix, "long") for mix in mixes),
                   (1, 2048, zamba.d_inner, zamba.ssm_state, SSM_F32_MIX,
                    "long"))
    timed = (1, 2048, d_inner, n_state, SSM_MODEL_MIX)
    zamba2 = (1, 2048, zamba.d_inner, zamba.ssm_state, SSM_F32_MIX, "f64")
    # zamba2's Mamba2 call (N 64: the ssm_scan64 build), held to float64
    z_d, z_n = zamba.d_inner, zamba.ssm_state
    mamba2 = ("mamba2", "f64")
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
        "shape_kwargs": _ssm_state_kwargs,
        "library": None,        # no one PyTorch call computes the scan
        "inputs": inputs, "compare": compare, "bound": bound,
        "tolerance": f"|kernel - plain| <= {SSM_TOL} + {SSM_TOL} * |plain| "
                     f"for y and the final state, any input dtypes; a "
                     f"second call bit-identical; a check held to float64: "
                     f"|kernel - exact| <= {SSM_TOL} + {SSM_TOL} * "
                     f"sum_n |h_n C_n| for y, {SSM_TOL} + {SSM_TOL} * "
                     f"|exact| for the state; a bf16 state: the state bit "
                     f"for bit, y within {SSM_TOL} + {SSM_TOL} * "
                     f"sum_n |h_n C_n| of the plain y",
        "describe": describe,
        # (B, S, D, N, dtypes) of every prefill and forward of the SSM serve
        # phases and of train_ssm's forward; the first is the timed one.
        # serve_ssm_f32's oracle runs a forward at every length from the
        # prompt's to the prompt's plus F32_NEW - 1, and the engine's
        # prefill at the prompt's.  serve_ssm_bf16 prefills each prompt
        # alone with a bf16 state (and again in f32 for the state: the
        # first shapes).  Then the same for zamba2's Mamba2 layers
        # (serve_hybrid, serve_hybrid_f32, train_hybrid's forward).
        "main_shapes": (
            *((1, s, d_inner, n_state, SSM_MODEL_MIX)
              for s in sorted(set(SERVE_PROMPTS), reverse=True)),
            *((2, s, d_inner, n_state, SSM_MODEL_MIX) for s in sorted(
                {s for s in SERVE_PROMPTS if SERVE_PROMPTS.count(s) > 1})),
            *((1, s + d, d_inner, n_state, SSM_F32_MIX) for s in F32_PROMPTS
              for d in range(F32_NEW)),
            *((1, s, d_inner, n_state, SSM_MODEL_MIX, BF16_STATE)
              for s in sorted(set(SERVE_PROMPTS), reverse=True)),
            *((1, s, z_d, z_n, SSM_MODEL_MIX, *mamba2)
              for s in sorted(set(SERVE_PROMPTS), reverse=True)),
            *((2, s, z_d, z_n, SSM_MODEL_MIX, *mamba2) for s in sorted(
                {s for s in SERVE_PROMPTS if SERVE_PROMPTS.count(s) > 1})),
            *((1, s + d, z_d, z_n, SSM_F32_MIX, *mamba2) for s in F32_PROMPTS
              for d in range(F32_NEW)),
        ),
        # the serving shape, then zamba2-7b's Mamba2 call at a 2048-token
        # prefill (d_inner 7168 in 112 heads, N 64), held to float64; then
        # both with the state in bf16
        "timed": (timed, (1, 2048, z_d, z_n, SSM_MODEL_MIX, *mamba2),
                  (*timed, BF16_STATE),
                  (1, 2048, z_d, z_n, SSM_MODEL_MIX, "mamba2", BF16_STATE)),
        # the JAX sweep (tests/test_kernels.py), ragged S and D; N that is
        # no multiple of a channel's lanes, S of 1 and of no whole chunk or
        # group, D of no whole CTA, B = 2 at the serving width; N up to 64
        # (the second build); each all-f32, with the model's mix and with
        # another mix.  Then channels of long memory, the last at zamba2's
        # width, and zamba2's width with the default inputs, held to float64.
        # Then the state in bf16: the ragged sizes all-f32 and in the
        # model's mix, the long-memory inputs, and zamba2's Mamba2 call.
        "sweep": (
            *((*size, mix) for size in sweep_sizes for mix in mixes),
            *long_shapes,
            zamba2,
            *((*size, mix, BF16_STATE) for size in sweep_sizes
              for mix in mixes[:2]),
            *((*shape, BF16_STATE) for shape in long_shapes),
            (1, 2048, z_d, z_n, SSM_MODEL_MIX, "mamba2", BF16_STATE)),
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
        shapes = [(s, True) for s in spec["main_shapes"]] + [
            (s, False) for s in spec["sweep"]]
        checks = [check_kernel(spec, shape, gen, main_path)
                  for shape, main_path in shapes]
        max_err = max(c["max_abs_err"] for c in checks)
        # the first main-path shape goes into the kernel summary line;
        # "timed" names more shapes to time (their numbers go to this line)
        timings = [_time_kernel(spec, shape, gen) for shape in
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


def _shape_kwargs(spec, shape) -> dict:
    """The keyword arguments the shape names (flash_attention: causal)."""
    return spec.get("shape_kwargs", lambda _: {})(shape)


def _kwargs(spec, shape) -> dict:
    """The wrapper's and the plain version's keyword arguments at
    ``shape``: the spec's own and the shape's."""
    return {**spec.get("kwargs", {}), **_shape_kwargs(spec, shape)}


def check_kernel(spec, shape, gen, main_path: bool) -> dict:
    """The kernel's wrapper against its plain version on inputs at
    ``shape``; raises unless they agree within the spec's tolerance."""
    kw = _kwargs(spec, shape)
    args = spec["inputs"](shape, gen)
    out = spec["wrapper"](*args, **kw)
    ref = spec["plain"](*args, **kw)
    sync()
    err, ok, info = spec["compare"](out, ref, args, shape=shape)
    if not ok:
        raise AssertionError(f"{spec['name']} disagrees with its plain "
                             f"version at {shape}: max abs err {err}")
    return {**spec["describe"](shape), "main_path": main_path,
            "max_abs_err": err, **info}


def _time_kernel(spec, shape, gen) -> dict:
    """The kernel's time at ``shape`` beside its bound, its plain version's
    and its library yardstick's, on inputs to which the kernel and the
    yardstick are first held as a check holds them."""
    kw, lib_kw = _kwargs(spec, shape), _shape_kwargs(spec, shape)
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
        lib_err, lib_ok, _ = spec["compare"](
            spec["library"](*args, **lib_kw), spec["plain"](*args, **kw),
            args, yardstick=True)
        if not lib_ok:
            raise AssertionError(f"{spec['name']}: library yardstick "
                                 f"differs by {lib_err}")
        library_ms = time_ms(lambda: spec["library"](*args, **lib_kw))
    ms = time_ms(lambda: spec["wrapper"](*args, **kw))
    plain_ms = time_ms(lambda: spec["plain"](*args, **kw), reps=3, warmup=1)
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


def _numpy_join_summary(spec, parts: int = 1):
    """The join task's summary by numpy: every part's left rows joined with
    every part's right rows."""
    from repro_torch.dataframe.shuffle import _gen_part
    left, right = ({k: np.concatenate([c[k] for c in cs]) for k in cs[0]}
                   for cs in ([_gen_part(spec, p, side) for p in range(parts)]
                              for side in (0, 1)))
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


def _free_gb() -> float:
    return torch.cuda.mem_get_info()[0] / 1e9


def _spanning(ex, name, fn, ranks, spec, **kw):
    """``fn(comm, spec)`` as one task of ``ranks`` ranks; returns the task
    and its wall seconds."""
    from repro_torch.core import SchedulerSession, TaskDescription, TaskState
    t0 = time.perf_counter()
    rep = SchedulerSession(ex, ex.resource_manager()).run(
        [TaskDescription(name=name, ranks=ranks, fn=fn, args=(spec,),
                         tags={"pipeline": "process"}, **kw)], timeout=600)
    task = rep.tasks[0]
    if task.state != TaskState.DONE:
        raise AssertionError(f"{name}: {task.state} {task.error}")
    return task, time.perf_counter() - t0, rep


def _transport(task, wall_s, rep) -> dict:
    """A spanning task's wall, transport counters, and its parts' flight-
    recorder spans summed by kind, seconds per worker (host clock)."""
    spans: dict = {}
    for sp in rep.spans:
        if sp["uid"] == task.uid:
            w = spans.setdefault(sp["worker"], {})
            w[sp["kind"]] = w.get(sp["kind"], 0.0) + sp["t1"] - sp["t0"]
    return {"wall_s": wall_s, "p2p_bytes": task.p2p_bytes,
            "shm_bytes": task.shm_bytes, "hub_calls": task.hub_calls,
            "p2p_fallbacks": task.p2p_fallbacks, "spills": task.spills,
            "workers": sorted({d.worker for d in task.devices}),
            "span_s": spans}


def phase_process(records, thread_makespans, device=None):
    """The multi-process pilot on one card: 2 workers of 2 ranks, both on
    cuda:0 (``device`` None: the executor's default, the card).  Every
    expected result is computed before the workers start:
    numpy holding the interpreter lock for seconds would stall the threads
    that read the workers' heartbeats."""
    from repro_torch import etl
    from repro_torch.core import ProcessExecutor
    from repro_torch.dataframe.shuffle import _gen_part, join_task, sort_task
    n = PROC_WORKERS * PROC_RANKS
    sort_spec = {"rows_per_part": PROC_SORT_ROWS, "seed": 11,
                 "verify_kernel": True}
    keys = np.concatenate([_gen_part(sort_spec, p)["key"]
                           for p in range(PROC_WORKERS)])
    want_sort = {"n": len(keys), "key_sum": _u64sum(keys), "sorted": True}
    del keys
    join_spec = {"rows_per_part": PROC_JOIN_ROWS, "key_range": 4_000_000,
                 "seed": 12, "verify_kernel": True}
    want_join = _numpy_join_summary(join_spec, PROC_WORKERS)
    kill_spec = {"rows_per_part": 1_000_000, "seed": 13, "stall_s": 4.0}
    kill_keys = _gen_part(kill_spec, 0)["key"]
    want_kill = {"n": len(kill_keys), "key_sum": _u64sum(kill_keys),
                 "sorted": True}
    free_device_memory()
    out = {"workers": PROC_WORKERS, "ranks_per_worker": PROC_RANKS,
           "free_gb_before": _free_gb()}
    launches: dict = {}

    def census(step):
        """Each worker's radix_partition launches since the last census."""
        counts = etl.run_spanning(ex, "census", etl.radix_launches,
                                  reset=True).result
        for pid, c in counts.items():
            launches[pid] = launches.get(pid, 0) + c
        out.setdefault("launches_by_step", {})[step] = {
            str(pid): c for pid, c in counts.items()}

    t0 = time.perf_counter()
    ex = ProcessExecutor(n_workers=PROC_WORKERS,
                         devices_per_worker=PROC_RANKS, device=device).start()
    try:
        out["start_s"] = time.perf_counter() - t0
        out["hello_s"] = {w.wid: w.hello_s for w in ex.workers.values()}
        out["worker_devices"] = {w.wid: w.device
                                 for w in ex.workers.values()}
        if set(out["worker_devices"].values()) != {device or "cuda:0"}:
            raise AssertionError(f"workers on {out['worker_devices']}")
        pids = {w.proc.pid for w in ex.workers.values()}
        out["free_gb_with_workers"] = _free_gb()
        # first use in each worker (kernel load, allocator), then zero the
        # workers' counts: the warm-up stays out of them, as in pipeline
        _, out["warm_up_s"] = wall(lambda: etl.warm_up(executor=ex))
        etl.run_spanning(ex, "census", etl.radix_launches, reset=True)

        runs = etl.run(rows=PIPE_ROWS, sort_sleep=0.0, join_sleep=0.0,
                       backend="process", executor=ex, timeout=600)
        out["pipeline"] = {
            "rows_per_task": PIPE_ROWS,
            "makespan_s": {p: rep.makespan for p, (_, rep) in runs.items()},
            "thread_backend_makespan_s": thread_makespans,
            "merge": {p: res[("sort", "merge")]
                      for p, (res, _) in runs.items()}}
        out["merge_all"], out["merge_all_s"] = wall(
            lambda: etl.merge_all(ex, PIPE_ROWS))
        census("pipeline")

        task, s, rep = _spanning(ex, "sort", sort_task, n, sort_spec)
        res = task.result
        if {k: res[k] for k in want_sort} != want_sort:
            raise AssertionError(f"spanning sort_task {res} vs numpy "
                                 f"{want_sort}")
        out["sort_task"] = {"rows_per_part": PROC_SORT_ROWS,
                            "rows": want_sort["n"],
                            **_transport(task, s, rep)}
        census("sort_task")

        task, s, rep = _spanning(ex, "join", join_task, n, join_spec)
        res = task.result
        if {k: res[k] for k in want_join} != want_join:
            raise AssertionError(f"spanning join_task {res} vs numpy "
                                 f"{want_join}")
        out["join_task"] = {"rows_per_part": PROC_JOIN_ROWS,
                            "pairs": res["n"], **_transport(task, s, rep)}
        census("join_task")
        missing = [pid for pid in pids if launches.get(pid, 0) <= 0]
        if missing:
            raise AssertionError(f"radix_partition never launched in worker "
                                 f"processes {missing}: {launches}")
        records["radix_partition"]["launches"] += sum(launches.values())
        out["radix_launches_by_worker"] = {str(p): c
                                           for p, c in launches.items()}

        # SIGKILL the worker under a 2-rank task (both ranks on one worker)
        from repro_torch.core import SchedulerSession, TaskDescription
        sess = SchedulerSession(ex, ex.resource_manager())
        sess.submit([TaskDescription(name="victim", ranks=2, fn=sort_task,
                                     args=(kill_spec,), max_retries=2,
                                     tags={"pipeline": "process"})])
        time.sleep(1.5)
        victim = next(iter(ex._running.values())).task.devices[0].worker
        out["free_gb_before_kill"] = _free_gb()
        t_kill = time.perf_counter()
        ex.kill_worker(victim)
        rep = sess.drain(timeout=600).close()
        task = rep.tasks[0]
        if not (task.result == dict(want_kill, spills=0) and task.retries
                and len(rep.events("device_failure")) == 1
                and victim not in {d.worker for d in task.devices}):
            raise AssertionError(f"killed worker's task: {task.state} "
                                 f"{task.error} {task.result}")
        out["kill"] = {"victim": victim, "retries": task.retries,
                       "recovered_s": time.perf_counter() - t_kill,
                       "survivor": sorted({d.worker for d in task.devices})}
        time.sleep(2.0)
        out["free_gb_2s_after_kill"] = _free_gb()
    finally:
        ex.shutdown()
    alive = [w.wid for w in ex.workers.values() if w.proc.poll() is None]
    if alive:
        raise AssertionError(f"workers {alive} outlived shutdown()")
    out["free_gb_after_shutdown"] = _free_gb()
    out["executor_totals"] = {"p2p_bytes": ex.p2p_bytes,
                              "shm_bytes": ex.shm_bytes,
                              "hub_calls": ex.hub_calls,
                              "hub_relay_bytes": ex.hub_relay_bytes}
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


SERVE_TRAFFIC = (SERVE_PROMPTS, SERVE_BUDGETS, SERVE_MAX_SEQ)
AUDIO_TRAFFIC = (AUDIO_PROMPTS, AUDIO_BUDGETS, AUDIO_TEXT_CTX)


def phase_serve(cfg, params, devices, traffic=SERVE_TRAFFIC):
    """Both acts of python -m repro_torch.serve_lm at ``cfg``'s widths on
    ``traffic`` (prompt lengths, new tokens, the engines' max_seq).
    Returns the phase's record, the continuous engine and the requests."""
    from repro_torch.serve_lm import (act_continuous, act_static,
                                      make_requests)
    prompts, budgets, max_seq = traffic
    reqs = make_requests(cfg, prompts, budgets)
    tokens = sum(r.max_new_tokens for r in reqs)
    kw = dict(max_batch=SERVE_MAX_BATCH, max_seq=max_seq,
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
    prefills = sum(-(-prompts.count(n) // SERVE_MAX_BATCH)
                   for n in set(prompts)) + len(reqs)
    return {
        "requests": len(reqs), "prompt_lengths": prompts,
        "max_new_tokens": budgets, "max_seq": max_seq,
        "generated_tokens": tokens,
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
    one prefill of the longest prompt."""
    from repro_torch.serve import Request
    lengths = sorted({len(r.prompt) for r in reqs})
    prefill_ms = {}
    for n in lengths:
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
    longest = next(r for r in reqs if len(r.prompt) == lengths[-1])
    return {"prefill_ms": prefill_ms,
            "decode_ms_per_round": statistics.median(rounds[2:]),
            "decode_live_slots": SERVE_MAX_BATCH,
            f"profile_prefill_{lengths[-1]}": profile(
                lambda: engine.prefill_request(longest))}


def launches_per_forward(cfg) -> dict:
    """The kernel launches one forward or prefill of ``cfg`` makes:
    flash_attention once a layer (an encoder-decoder: once an encoder
    layer, twice a decoder layer: its self- and cross-attention; the
    hybrid: once a group, the shared block's application), ssm_scan once a
    Mamba layer."""
    if cfg.family == "ssm":
        return {"ssm_scan": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"flash_attention": cfg.n_layers // cfg.shared_attn_period,
                "ssm_scan": cfg.n_layers}
    if cfg.family == "audio":
        return {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers}
    return {"flash_attention": cfg.n_layers}


def run_serve(arch, specs, records, kernels, extra=None,
              traffic=SERVE_TRAFFIC, hold=None):
    """``arch`` at its published widths in bf16 through phase_serve on
    ``traffic`` under MainPath(``kernels``), then its timings and
    ``extra(cfg, params)``'s record, if given.  Each model kernel of the
    family launched exactly ``launches_per_forward`` times a prefill, and
    nothing else launched it.  Returns the phase's record (the main-path
    run's launch counts under ``launches``); the weights go into ``hold``
    under "params", if given, for a later phase."""
    from repro_torch.configs import get_config
    from repro_torch.core import logical_devices
    from repro_torch.models.transformer import param_count
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.engine import prompt_prefix_len
    cfg = get_config(arch)
    free_device_memory()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    params, init_s = wall(lambda: serve_model(cfg))
    weights_gb = sum(p.numel() * p.element_size()
                     for p in params.parameters()) / 1e9
    # first-use costs (cuBLAS handles, the allocator) before the count
    ServeEngine(cfg, params, max_batch=1,
                max_seq=prompt_prefix_len(cfg) + 128).run_requests(
        [Request(prompt=np.arange(64, dtype=np.int32), max_new_tokens=2)])
    with MainPath(specs, records, kernels) as mp:
        res, engine, reqs = phase_serve(cfg, params,
                                        logical_devices(N_RANKS, "cuda:0"),
                                        traffic)
    counts = mp.counts()
    per_prefill = launches_per_forward(cfg)
    for kernel, n in per_prefill.items():
        if counts[kernel] != n * res["prefills"]:
            raise AssertionError(f"{arch}: {kernel} launched "
                                 f"{counts[kernel]} times for "
                                 f"{res['prefills']} prefills of {n}")
    res.update(serve_timings(engine, reqs))
    if extra is not None:
        res.update(extra(cfg, params))
    if hold is not None:
        hold["params"] = params
    res.update(arch=arch, n_layers=cfg.n_layers,
               launches_per_prefill=per_prefill,
               param_count=param_count(params), weights_gb=weights_gb,
               init_s=init_s, launches=counts, allocated_gb_at_start=start_gb,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return res


def phase_serve_ssm_bf16(specs, records, params, base):
    """falcon-mamba-7b whole at its published widths in bf16 (serve_ssm's
    weights) with ssm_scan_dtype="bfloat16": the continuous engine over
    serve_ssm's requests (each prompt's prefill alone, then the decode
    rounds), ssm_scan twice a layer a prefill (y from the bf16 state, the
    state handed to decode from an f32 launch, as the JAX prefill's second
    pass), none in decode (f32, plain); then serve_timings beside
    serve_ssm's (``base``).  Last, each prompt length's prefill once more,
    each layer's returned state held bit for bit to the f32 mode's state on
    that layer's scan inputs.  Tokens are not held to a full forward: the
    forward scans with a bf16 state while decode goes on from an f32 one,
    as in the JAX package, so they may part."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.models import ssm as model_ssm
    from repro_torch.serve import ContinuousEngine
    from repro_torch.serve_lm import make_requests
    cfg = dataclasses.replace(get_config(SSM_ARCH),
                              ssm_scan_dtype="bfloat16")
    reqs = make_requests(cfg, SERVE_PROMPTS, SERVE_BUDGETS)
    engine = ContinuousEngine(cfg, params, max_batch=SERVE_MAX_BATCH,
                              max_seq=SERVE_MAX_SEQ)
    with MainPath(specs, records, ("ssm_scan",)) as mp:
        out, run_s = wall(lambda: engine.run(reqs))
    counts = mp.counts()
    _check_tokens(cfg, reqs, out, "bf16 state")
    if counts["ssm_scan"] != 2 * cfg.n_layers * len(reqs):
        raise AssertionError(f"ssm_scan launched {counts['ssm_scan']} times"
                             f" for {len(reqs)} prefills of "
                             f"{2 * cfg.n_layers}")
    res = {"arch": SSM_ARCH, "ssm_scan_dtype": cfg.ssm_scan_dtype,
           "requests": len(reqs), "prompt_lengths": SERVE_PROMPTS,
           "max_new_tokens": SERVE_BUDGETS, "run_s": run_s,
           "launches_per_prefill": {"ssm_scan": 2 * cfg.n_layers},
           "launches": counts, **serve_timings(engine, reqs),
           "serve_ssm": {k: base[k] for k in ("prefill_ms",
                                              "decode_ms_per_round")}}
    # the f32 mode's state on each bf16-state call's inputs, layer by layer
    states, scan = [], model_ssm.ssm_scan

    def checking(*args, state_dtype=torch.float32, **kw):
        if state_dtype == BF16:
            states.append(ops.ssm_scan(*args, return_state=True)[1])
        return scan(*args, state_dtype=state_dtype, **kw)
    model_ssm.ssm_scan = checking
    try:
        for n in sorted(set(SERVE_PROMPTS)):
            states.clear()
            adm = engine.prefill_request(next(r for r in reqs
                                              if len(r.prompt) == n))
            if len(states) != cfg.n_layers or not all(
                    torch.equal(adm.cache["h"][i], h)
                    for i, h in enumerate(states)):
                raise AssertionError(f"a {n}-token prefill's states differ "
                                     f"from the f32 mode's")
    finally:
        model_ssm.ssm_scan = scan
    res["prefill_state_equals_f32_mode"] = sorted(set(SERVE_PROMPTS))
    return res


def free_device_memory():
    """Drop what an earlier phase left: the scheduler's tasks, closures and
    threads hold the engines, and so the weights, in reference cycles that
    only the cycle collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_f32(arch, **overrides):
    """``arch``'s widths, 2 layers (unless ``overrides`` of its config say
    otherwise), float32: the continuous engine (prefill through the
    kernels, plain decode) against greedy_reference (a full forward
    through the kernels per token), token for token."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.serve import ContinuousEngine, greedy_reference
    from repro_torch.serve.engine import prompt_prefix_len
    from repro_torch.serve_lm import make_requests
    # full f32 products and convolutions on both sides of the comparison:
    # TF32 would keep about three digits and let near-tied logits flip
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    overrides = {"n_layers": 2, **overrides}
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **overrides)
    free_device_memory()
    params = serve_model(cfg)
    reqs = make_requests(cfg, F32_PROMPTS, [F32_NEW] * len(F32_PROMPTS),
                         seed=1)
    out = ContinuousEngine(cfg, params, max_batch=2,
                           max_seq=prompt_prefix_len(cfg) + 512).run(reqs)
    for r in reqs:
        ref = greedy_reference(cfg, params, r.prompt, r.max_new_tokens)
        if not np.array_equal(out[r.uid], ref):
            raise AssertionError(f"f32 request {r.uid}: {out[r.uid]} != "
                                 f"oracle {ref}")
    return {"arch": arch, **overrides, "dtype": "float32",
            "prompt_lengths": F32_PROMPTS, "max_new_tokens": F32_NEW,
            "tokens_equal_oracle": True, "tf32": False}


# ---------------------------------------------------------------------------
# the MoE family: qwen2-moe-a2.7b and one superblock of llama4-maverick at
# their published widths
# ---------------------------------------------------------------------------
class MoEDrops:
    """While inside, count the (token, expert) pairs of every moe_ffn call
    on the card and the pairs it drops past the call's capacity, by routing
    each call's tokens once more beside it (a measurement, outside the
    call)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.orig = moe, moe.moe_ffn
        self.calls, self.pairs, self._dropped = 0, 0, []

        def counting(p, x, cfg):
            if x.device.type != "meta":     # the engines' layout probe
                xt = x.reshape(-1, x.shape[-1])
                cap = moe.capacity(xt.shape[0], cfg)
                idx, _ = moe.route(p, xt, cfg)
                _, pos = moe.dispatch_indices(idx, cfg.n_experts, cap)
                self.calls += 1
                self.pairs += pos.numel()
                self._dropped.append((pos >= cap).sum())
            return self.orig(p, x, cfg)
        moe.moe_ffn = counting
        return self

    def __exit__(self, *_):
        self.mod.moe_ffn = self.orig
        return False

    def record(self) -> dict:
        dropped = int(sum(int(d) for d in self._dropped))
        return {"moe_calls": self.calls, "pairs": self.pairs,
                "dropped": dropped,
                "dropped_share": dropped / max(self.pairs, 1)}


def moe_drop_shares(cfg, params) -> dict:
    """The share of pairs dropped at ``cfg``'s capacity factor over every
    MoE layer of one prefill of B x 2048 tokens, B in MOE_DROP_BATCHES
    (act 1 prefills the two 2048-token prompts as one batch of 2; a full
    batch is SERVE_MAX_BATCH)."""
    from repro_torch.models import get_model
    api, rng = get_model(cfg), np.random.default_rng(7)
    out = {}
    with torch.inference_mode():
        for b in MOE_DROP_BATCHES:
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, MOE_DROP_SEQ))).to(CARD)
            with MoEDrops() as drops:
                api.prefill(params, cfg, {"tokens": toks}, MOE_DROP_SEQ)
            out[f"{b}x{MOE_DROP_SEQ}"] = drops.record()
    return {"capacity_factor": cfg.capacity_factor, "drops": out}


def moe_oracle_check(gen) -> dict:
    """One MoE layer at qwen2-moe's widths in f32 (TF32 off), cf 1.25:
    moe_ffn on the card against moe_ffn_dense_oracle with the pairs moe_ffn
    drops masked out, for MOE_ORACLE_TOKENS tokens, within MOE_ORACLE_RTOL
    of the oracle output's largest magnitude.  The tokens share one random
    vector plus unit noise each, so that routing is skewed and pairs drop
    (independent normal tokens overflow no expert at cf 1.25, and the check
    would not reach the drop path)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config(MOE_ARCH), dtype="float32")
    p = moe.moe_init(gen, cfg, torch.float32)
    rows = []
    with torch.inference_mode():
        for t in MOE_ORACLE_TOKENS:
            x = torch.randn((t, cfg.d_model), generator=gen, device=CARD) \
                + torch.randn((cfg.d_model,), generator=gen, device=CARD)
            cap = moe.capacity(t, cfg)
            idx, _ = moe.route(p, x, cfg)
            _, pos = moe.dispatch_indices(idx, cfg.n_experts, cap)
            keep = (pos < cap).view(t, cfg.top_k)
            got = moe.moe_ffn(p, x, cfg)
            want = moe.moe_ffn_dense_oracle(p, x, cfg, keep)
            err, scale = float((got - want).abs().max()), \
                float(want.abs().max())
            if not err <= MOE_ORACLE_RTOL * scale:
                raise AssertionError(f"moe_ffn at T={t} is {err} from the "
                                     f"masked oracle (largest |out| {scale})")
            if keep.all():
                raise AssertionError(f"no pair dropped at T={t}: the check "
                                     f"did not reach the drop path")
            rows.append({"tokens": t, "capacity": cap,
                         "dropped": int((~keep).sum()),
                         "dropped_share": float((~keep).float().mean()),
                         "max_abs_err": err, "max_abs_out": scale})
    return {"capacity_factor": cfg.capacity_factor,
            "tolerance": f"{MOE_ORACLE_RTOL} x max |oracle|", "checks": rows}


def phase_serve_moe_f32(gen):
    """qwen2-moe's widths, 2 layers, f32 (phase_serve_f32) with the
    capacity factor raised to n_experts / top_k, so that C >= T and no pair
    drops: the oracle re-runs the whole sequence at another token count,
    and a drop there would change its answer, not the engine's.  Then the
    drop path itself, at cf 1.25, against the masked dense oracle."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    no_drop = cfg.n_experts / cfg.top_k
    with MoEDrops() as drops:
        res = phase_serve_f32(MOE_ARCH, capacity_factor=no_drop)
    rec = drops.record()
    if rec["dropped"] or not rec["pairs"]:
        raise AssertionError(f"the f32 token check dropped pairs: {rec}")
    return {**res, "capacity_factor": no_drop,
            "capacity_factor_note": f"raised from {cfg.capacity_factor} "
                                    f"so that no pair drops",
            "routing": rec, "drop_path": moe_oracle_check(gen)}


def phase_serve_llama4(specs, records):
    """llama4-maverick at its published widths on one superblock (2 of 48
    layers: a dense layer of d_ff 16384, then an MoE layer of 128 experts),
    bf16: ServeEngine serves LLAMA4_PROMPTS with LLAMA4_NEW new tokens
    each, one prefill per length, flash_attention twice a prefill; then
    prefill ms per length, decode ms per round with SERVE_MAX_BATCH live
    rows, and a profile of one 2048-token prefill."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.transformer import param_count
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve_lm import make_requests
    cfg = dataclasses.replace(get_config(LLAMA4_ARCH),
                              n_layers=get_config(LLAMA4_ARCH)
                              .moe_layer_period)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    params, init_s = wall(lambda: serve_model(cfg))
    weights_gb = sum(p.numel() * p.element_size()
                     for p in params.parameters()) / 1e9
    max_seq = max(LLAMA4_PROMPTS) + LLAMA4_NEW
    ServeEngine(cfg, params, max_batch=1, max_seq=128).run_requests(
        [Request(prompt=np.arange(64, dtype=np.int32), max_new_tokens=2)])
    reqs = make_requests(cfg, LLAMA4_PROMPTS,
                         [LLAMA4_NEW] * len(LLAMA4_PROMPTS), seed=2)
    engine = ServeEngine(cfg, params, max_batch=SERVE_MAX_BATCH,
                         max_seq=max_seq)
    with MainPath(specs, records, ("flash_attention",)) as mp:
        out, serve_s = wall(lambda: engine.run_requests(reqs))
    counts = mp.counts()
    _check_tokens(cfg, reqs, out, "serve_llama4")
    want = cfg.n_layers * len(set(LLAMA4_PROMPTS))
    if counts["flash_attention"] != want:
        raise AssertionError(f"serve_llama4: flash_attention launched "
                             f"{counts['flash_attention']} times, not {want}")
    api = get_model(cfg)
    rng = np.random.default_rng(3)

    def tokens(b, n):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (b, n))).to(CARD)
    with torch.inference_mode():
        prefill_ms = {n: statistics.median(
            wall(lambda: api.prefill(params, cfg, {"tokens": tokens(1, n)},
                                     max_seq))[1] * 1e3 for _ in range(3))
            for n in LLAMA4_PROMPTS}
        cache, logits = api.prefill(params, cfg, {"tokens": tokens(
            SERVE_MAX_BATCH, LLAMA4_DECODE_FROM)}, max_seq)
        pos = torch.full((SERVE_MAX_BATCH,), LLAMA4_DECODE_FROM, device=CARD)
        rounds = []
        for i in range(12):
            nxt = logits.argmax(-1)[:, None]
            (logits, cache), t = wall(lambda: api.decode_step(
                params, cfg, {"tokens": nxt, "positions": pos + i}, cache))
            rounds.append(t * 1e3)
        prof = profile(lambda: api.prefill(
            params, cfg, {"tokens": tokens(1, max(LLAMA4_PROMPTS))}, max_seq))
    tokens_out = len(reqs) * LLAMA4_NEW
    return {"arch": LLAMA4_ARCH, "n_layers": cfg.n_layers,
            "layers_of": get_config(LLAMA4_ARCH).n_layers,
            "groups": [layer.group for layer in params.layers],
            "n_experts": cfg.n_experts, "top_k": cfg.top_k,
            "d_ff": cfg.d_ff, "d_ff_dense": cfg.d_ff_dense,
            "param_count": param_count(params), "weights_gb": weights_gb,
            "init_s": init_s, "prompt_lengths": LLAMA4_PROMPTS,
            "max_new_tokens": LLAMA4_NEW, "serve_wall_s": serve_s,
            "tokens_per_s": tokens_out / serve_s,
            "flash_attention_launches_per_prefill": cfg.n_layers,
            "prefill_ms": prefill_ms,
            "decode_ms_per_round": statistics.median(rounds[2:]),
            "decode_live_rows": SERVE_MAX_BATCH,
            "profile_prefill_2048": prof,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts}


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

# ---------------------------------------------------------------------------
# training: the ETL -> train pipeline, qwen3-8b's widths, the CPU twin, and a
# checkpointed task retried on the thread executor
# ---------------------------------------------------------------------------
class RadixShapes:
    """Record the (n, B) of every radix_partition call the dist ops make
    while inside, so that the kernel can be held to its plain version at
    exactly those shapes afterwards."""

    def __enter__(self):
        from repro_torch.dataframe import ops_dist
        self.mod, self.orig, self.shapes = ops_dist, \
            ops_dist.radix_partition, set()

        def recording(b, n_buckets):
            self.shapes.add((int(b.shape[0]), int(n_buckets)))
            return self.orig(b, n_buckets)
        ops_dist.radix_partition = recording
        return self

    def __exit__(self, *_):
        self.mod.radix_partition = self.orig
        return False


def _step_times(state: dict):
    """An ``on_metrics`` callback stamping each step's end (the trainer
    reads the loss, so each stamp follows a synchronised step)."""
    def stamp(step, _metrics):
        state.setdefault("t", [time.perf_counter()])
        state["t"].append(time.perf_counter())
    return stamp


def _step_ms(stamps: list) -> float:
    """Median step time, the first step (first-use costs) left out."""
    return statistics.median(np.diff(stamps[1:])) * 1e3


class GemmCount(TorchDispatchMode):
    """Counts the matrix products run while it is active (the autograd
    engine's threads inherit it): all of them, and those made inside
    ``layers.dense``, the weight products: in a backward, those are the
    ones its checkpoints recompute."""

    def __init__(self):
        super().__init__()
        from repro_torch.models import layers
        self.layers = layers
        self.all = self.weight = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.layers._PRODUCTS:
            self.all += 1
            self.weight += self.layers._weight_product.n > 0
        return func(*args, **(kwargs or {}))


def split_step(tr, state, batch, step_ms: float, remat_modes=()) -> dict:
    """Where a train step's time goes, after the phase's checks (the state
    moves on): the forward and backward alone and the AdamW update alone
    (CUDA events, median of 3), and one whole step under the profiler.  A
    step longer than ONCE_STEP_MS (falcon-mamba's and internvl2's) is timed
    once, and one longer than LONG_STEP_MS (zamba2's 18 layers: seconds and
    170 000 kernels) is not profiled, to keep the script within its time
    limit.  For each of ``remat_modes``, the forward and backward
    under that ``remat_mode``: its time, its peak memory, and the matrix
    products of its backward counted by GemmCount in one more run (the
    weight products among them are those recomputed: none under "dots")."""
    import dataclasses
    long = step_ms > LONG_STEP_MS
    reps = 1 if step_ms > ONCE_STEP_MS else 3
    from repro_torch.models.convert import decayed_names
    from repro_torch.train.optimizer import adamw_update
    batch = {k: torch.as_tensor(v).to(tr.device) for k, v in batch.items()}
    params = dict(state.params.named_parameters())
    mode = tr.bundle.info["mode"]

    def fwd_bwd(cfg=tr.cfg, count=None):
        loss = tr.api.loss_fn(state.params, cfg, batch, mode)
        if count is None:
            return torch.autograd.grad(loss, list(params.values()))
        with count:
            return torch.autograd.grad(loss, list(params.values()))
    grads = dict(zip(params, fwd_bwd()))
    decay = decayed_names(params, tr.cfg)
    out = {"fwd_bwd_ms": time_ms(fwd_bwd, reps=reps, warmup=1),
           "optimizer_ms": time_ms(lambda: adamw_update(
               grads, state.opt_state, params, tr.ocfg, decay), reps=reps,
               warmup=1)}
    del grads
    remat = {}
    for rm in remat_modes:
        cfg = dataclasses.replace(tr.cfg, remat_mode=rm)
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: fwd_bwd(cfg), reps=reps, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        count = GemmCount()
        fwd_bwd(cfg, count)
        remat[rm] = {"fwd_bwd_ms": ms, "peak_gb": peak,
                     "backward_gemms": count.all,
                     "backward_recomputed_weight_gemms": count.weight}
    if remat:
        if remat.get("dots", {}).get("backward_recomputed_weight_gemms"):
            raise AssertionError(f"remat_mode dots recomputed weight "
                                 f"products: {remat['dots']}")
        if "nothing" in remat and \
                not remat["nothing"]["backward_recomputed_weight_gemms"]:
            raise AssertionError("remat_mode nothing recomputed no weight "
                                 "product: the count sees no backward")
        out["remat_modes"] = remat
    if not long:
        out["profile_step"] = profile(lambda: tr.bundle.fn(
            state.params, state.opt_state, batch))
    return out


def phase_train_etl(specs, records, gen):
    """The full preset fed by the ETL stage on N_RANKS logical ranks of
    cuda:0: TRAIN_ETL_SAVED steps saving every TRAIN_ETL_EVERY, then the
    same state on to TRAIN_ETL_STEPS without saving (the uninterrupted
    run), and a fresh trainer restoring TRAIN_ETL_SAVED and training to
    TRAIN_ETL_STEPS: restored parameters bit-equal, losses within
    TRAIN_RESUME_RTOL.  radix_partition is then held to its plain version
    at every (n, B) the ETL stage called it at."""
    import tempfile
    from repro_torch.configs import ParallelConfig
    from repro_torch.core import build_communicator, logical_devices
    from repro_torch.train.trainer import Trainer
    from repro_torch.train_lm import etl_batches, model_for, optimizer_for
    cfg, shape, _ = model_for("full")
    n, saved = TRAIN_ETL_STEPS, TRAIN_ETL_SAVED
    comm = build_communicator(logical_devices(N_RANKS, CARD))
    tokens = shape.global_batch * shape.seq_len
    out = {"preset": "full", "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
           "batch": shape.global_batch, "seq": shape.seq_len, "steps": n,
           "etl_ranks": N_RANKS}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckdir:
        def trainer(**kw):
            return Trainer(cfg, ParallelConfig(), shape, optimizer_for(n),
                           device=CARD, **kw)
        with MainPath(specs, records, ("radix_partition",
                                       "flash_attention")) as mp, \
                RadixShapes() as seen:
            (batches, made), etl_s = wall(
                lambda: etl_batches(cfg, shape, n, comm))
            radix_etl = mp.counts()["radix_partition"]
            tr = trainer(ckpt_dir=ckdir, ckpt_every=TRAIN_ETL_EVERY)
            state, stamps = tr.init_state(), {}
            params = sum(p.numel() for p in state.params.parameters())
            (state, first), s1 = wall(lambda: tr.fit(
                batches[:saved], saved, state, log_every=0,
                on_metrics=_step_times(stamps)))
            snap = [p.detach().clone() for p in state.params.parameters()]
            state, rest = trainer().fit(batches[saved:], n - saved, state,
                                        log_every=0)
            fa_uninterrupted = mp.counts()["flash_attention"]
            back = trainer(ckpt_dir=ckdir).maybe_restore()
            if back is None or back.step != saved:
                raise AssertionError(f"restored {back and back.step}, not "
                                     f"step {saved}")
            bit_equal = all(torch.equal(a, b) for a, b in
                            zip(back.params.parameters(), snap))
            back, resumed = trainer().fit(batches[saved:], n - saved, back,
                                          log_every=0)
        counts = mp.counts()
    losses = first + rest
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, rest))
    want_fa = cfg.n_layers * (2 if cfg.remat else 1)
    if not bit_equal:
        raise AssertionError("the restored parameters differ from step "
                             f"{saved}'s")
    if rel > TRAIN_RESUME_RTOL:
        raise AssertionError(f"resumed losses differ by {rel} relative")
    if not (losses[-1] < losses[0] and np.all(np.isfinite(losses))):
        raise AssertionError(f"the loss did not fall: {losses}")
    if fa_uninterrupted != want_fa * n or radix_etl <= 0:
        raise AssertionError(f"launches: flash_attention {fa_uninterrupted}"
                             f" for {n} steps of {want_fa}, radix_partition "
                             f"{radix_etl}")
    radix_spec = next(s for s in specs if s["name"] == "radix_partition")
    checks = [check_kernel(radix_spec, s, gen, True) for s in
              sorted(seen.shapes)]
    records["radix_partition"]["max_abs_err"] = max(
        records["radix_partition"]["max_abs_err"],
        max(c["max_abs_err"] for c in checks))
    step_ms = _step_ms(stamps["t"])
    out.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               **split_step(trainer(), back, batches[0], step_ms),
               param_count=params, etl_s=etl_s, etl_batches=made,
               radix_partition_launches_etl=radix_etl,
               radix_partition_shapes=checks,
               flash_attention_launches_per_step=want_fa,
               step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
               wall_s_first_40=s1, losses=losses, resumed_losses=resumed,
               restored_step=saved, restored_bit_equal=bit_equal,
               resume_max_rel_diff=rel, launches=counts)
    return out


def train_published(specs, records, arch, n_layers=None, steps=TRAIN_STEPS,
                    seq=TRAIN_SEQ, remat_modes=()) -> tuple:
    """``arch`` at its published widths in bf16, ``n_layers`` of its layers
    (all of them by default): ``steps`` AdamW steps on one fixed batch of 1
    x ``seq`` tokens (with a VLM's patch embeddings or an audio model's
    frames, drawn from a seed), each model kernel of the family
    ``launches_per_forward`` times a forward (twice under remat); the loss
    must fall.  The config's remat_mode is its default, "dots"; split_step
    also runs the forward and backward under each of ``remat_modes``.
    Returns the record and the trainer's attention mode."""
    import dataclasses
    from repro_torch.configs import ParallelConfig, ShapeConfig, get_config
    from repro_torch.models import make_concrete_batch, train_batch_shapes
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    shape = ShapeConfig("t", "train", seq, 1)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, ParallelConfig(), shape,
                 OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                 total_steps=steps), device=CARD)
    batch = make_concrete_batch(train_batch_shapes(cfg, 1, seq),
                                np.random.default_rng(0), cfg.vocab_size,
                                CARD)
    per_step = {k: n * (2 if cfg.remat else 1)
                for k, n in launches_per_forward(cfg).items()}
    with MainPath(specs, records, tuple(per_step)) as mp:
        state, init_s = wall(tr.init_state)
        stamps = {}
        (state, losses), fit_s = wall(lambda: tr.fit(
            [batch] * steps, steps, state, log_every=0,
            on_metrics=_step_times(stamps)))
    counts = mp.counts()
    for kernel, n in per_step.items():
        if counts[kernel] != n * steps:
            raise AssertionError(f"{arch}: {kernel} launched "
                                 f"{counts[kernel]} times in {steps} steps "
                                 f"of {n}")
    if not (losses[-1] < losses[0] and np.all(np.isfinite(losses))):
        raise AssertionError(f"the loss did not fall: {losses}")
    params = sum(p.numel() for p in state.params.parameters())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_gb >= 80:
        raise AssertionError(f"{arch}: a step's peak is {peak_gb} GB")
    step_ms = _step_ms(stamps["t"])
    split = split_step(tr, state, batch, step_ms, remat_modes)
    mode = tr.bundle.info["mode"]
    del state, tr
    free_device_memory()
    return {"arch": arch, "family": cfg.family, "n_layers": cfg.n_layers,
            "n_encoder_layers": cfg.n_encoder_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "dtype": cfg.dtype, "remat": cfg.remat,
            "remat_mode": cfg.remat_mode, "batch": 1, "seq": seq,
            "inputs": {k: list(v[0]) for k, v in
                       train_batch_shapes(cfg, 1, seq).items()},
            "param_count": params, "init_s": init_s,
            "fit_s": fit_s, "losses": losses, "step_ms": step_ms,
            "tokens_per_s": seq / step_ms * 1e3, "peak_gb": peak_gb,
            "launches_per_step": per_step, **split,
            "launches": counts}, mode


def phase_train_qwen3(specs, records, gen):
    """qwen3-8b at its published widths in bf16, TRAIN_QWEN3_LAYERS of its
    layers (train_published), with the forward and backward also timed
    under remat_mode "dots" and "nothing" (split_step).  Then the attention
    Function's gradients held bit-equal to autograd through the plain path
    the train step differentiates at that length."""
    from repro_torch.configs import get_config
    res, mode = train_published(specs, records, SERVE_ARCH,
                                TRAIN_QWEN3_LAYERS,
                                remat_modes=("dots", "nothing"))
    return {**res, "grad_check": attention_grad_check(get_config(SERVE_ARCH),
                                                      mode, gen)}


def attention_grad_check(cfg, mode, gen, s=TRAIN_SEQ) -> dict:
    """The attention Function's q, k and v gradients at ``cfg``'s attention
    over 1 x ``s`` tokens in bf16, held bit-equal to autograd through the
    plain path the train step differentiates at that length (``mode``)."""
    import functools
    from repro_torch.kernels.flash_attention.ops import FlashAttention
    from repro_torch.models.attention import attend_plain
    plain = functools.partial(attend_plain, mode=mode)
    q, k, v = (torch.randn((1, s, h, cfg.head_dim), generator=gen,
                           device="cuda").to(torch.bfloat16).requires_grad_()
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    g = torch.randn((1, s, cfg.n_heads, cfg.head_dim), generator=gen,
                    device="cuda").to(torch.bfloat16)
    got = torch.autograd.grad(FlashAttention.apply(q, k, v, True, plain),
                              (q, k, v), g)
    want = torch.autograd.grad(plain(q, k, v, causal=True), (q, k, v), g)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the attention Function's gradients differ from"
                             " autograd of the plain path")
    return {"shape": [1, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
            "dtype": "bfloat16", "backward_path": mode.kind,
            "bit_equal": True}


def phase_train_moe(specs, records):
    """qwen2-moe-a2.7b at its published widths in bf16, TRAIN_MOE_LAYERS of
    its 24 layers (train_published): every layer MoE, 60 experts top-4
    and 4 shared experts."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(MOE_ARCH)
    res, _ = train_published(specs, records, MOE_ARCH, TRAIN_MOE_LAYERS)
    return {**res, "n_experts": cfg.n_experts, "top_k": cfg.top_k,
            "n_shared_experts": cfg.n_shared_experts,
            "capacity": moe.capacity(TRAIN_SEQ, cfg)}


def phase_train_ssm(specs, records, gen):
    """falcon-mamba-7b at its published widths in bf16, TRAIN_SSM_LAYERS of
    its 64 layers (train_published): ssm_scan's forward under autograd
    through SSMScan.  Then SSMScan's gradients at one layer's shape held
    bit-equal to autograd of ssm_scan_chunked on the same inputs, and the
    backward's transient device memory above its inputs and output; the
    same with the state in bf16 (ssm_scan_dtype "bfloat16": the chunk of
    the model's ssm_chunk, 1024)."""
    from repro_torch.configs import get_config
    res, _ = train_published(specs, records, SSM_ARCH, TRAIN_SSM_LAYERS)
    cfg = get_config(SSM_ARCH)
    shape = (1, TRAIN_SEQ, cfg.d_inner, cfg.ssm_state, SSM_MODEL_MIX)
    return {**res, "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
            "grad_check": scan_grad_check(specs, shape, gen),
            "bf16_grad_check": scan_grad_check(specs, shape, gen, BF16,
                                               cfg.ssm_chunk)}


def scan_grad_check(specs, shape, gen, state_dtype=torch.float32,
                    chunk=None) -> dict:
    """SSMScan's gradients on the ssm_scan spec's inputs at ``shape``, the
    state in ``state_dtype`` and the backward's chunk ``chunk`` (default
    ops.SCAN_CHUNK), held bit-equal to autograd of ssm_scan_chunked, and
    the backward's transient device memory above its inputs and output."""
    from repro_torch.kernels.ssm_scan import ops as ssm
    spec = next(s for s in specs if s["name"] == "ssm_scan")
    b, s, d, n, dtypes = shape[:5]
    chunk = chunk or ssm.SCAN_CHUNK
    args = [t.detach().requires_grad_() for t in spec["inputs"](shape, gen)]
    g = torch.randn((b, s, d), generator=gen, device="cuda")
    y = ssm.SSMScan.apply(*args, state_dtype, chunk)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = torch.autograd.grad(y, args, g)
    sync()
    transient = torch.cuda.max_memory_allocated() - base
    want = torch.autograd.grad(ssm.ssm_scan_chunked(
        *args, chunk=chunk, state_dtype=state_dtype), args, g)
    if not all(torch.equal(x, w) for x, w in zip(got, want)):
        raise AssertionError("SSMScan's gradients differ from autograd of "
                             "ssm_scan_chunked")
    used = chunk if state_dtype == torch.float32 else ssm.jax_chunk(s, chunk)
    return {"shape": [b, s, d, n], "inputs": shape[5:],
            "dtypes": [str(t).removeprefix("torch.") for t in dtypes],
            "state_dtype": str(state_dtype).removeprefix("torch."),
            "scan_chunk": used, "bit_equal": True,
            "backward_transient_gb": transient / 1e9,
            "one_chunk_tensor_gb": b * used * d * n * 4e-9}


def phase_train_hybrid(specs, records, gen):
    """zamba2-7b at its published widths in bf16, TRAIN_HYBRID_LAYERS of
    its 81 layers: two groups of the published period 9, the least depth
    at which the shared block's gradient sums two applications
    (train_published; remat by group: each kernel twice a forward).  Then
    SSMScan's gradients at one Mamba2 layer's call (each head's dt and A
    repeated over its 64 channels), with the state in f32 and in bf16
    (chunk 1024), and FlashAttention's at the shared block's (1, 2048, 32,
    32, 112) in bf16, each bit-equal to autograd of its plain path."""
    from repro_torch.configs import get_config
    res, mode = train_published(specs, records, HYBRID_ARCH,
                                TRAIN_HYBRID_LAYERS)
    cfg = get_config(HYBRID_ARCH)
    mamba2 = (1, TRAIN_SEQ, cfg.d_inner, cfg.ssm_state, SSM_MODEL_MIX,
              "mamba2")
    return {**res, "shared_attn_period": cfg.shared_attn_period,
            "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
            "scan_grad_check": scan_grad_check(specs, mamba2, gen),
            "bf16_scan_grad_check": scan_grad_check(specs, mamba2, gen, BF16,
                                                    cfg.ssm_chunk),
            "attention_grad_check": attention_grad_check(cfg, mode, gen)}


def phase_train_full_depth(specs, records, arch, seq):
    """``arch`` at its published widths and full depth in bf16,
    TRAIN_FULL_STEPS steps (train_published)."""
    res, mode = train_published(specs, records, arch,
                                steps=TRAIN_FULL_STEPS, seq=seq)
    return {**res, "backward_path": mode.kind}


def phase_train_cpu_gpu(specs, records):
    """The ci preset for TRAIN_CPU_GPU_STEPS steps from the same parameters
    and batches on cuda:0 (TF32 off) and on the CPU: losses within
    TRAIN_CPU_GPU_RTOL."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_to_jax
    from repro_torch.train.data import SyntheticCorpus
    from repro_torch.train.trainer import Trainer
    from repro_torch.train_lm import model_for, optimizer_for
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, shape, _ = model_for("ci")
    steps = TRAIN_CPU_GPU_STEPS
    host = params_to_jax(get_model(cfg).init(
        torch.Generator().manual_seed(0), cfg))
    batches = list(SyntheticCorpus(cfg.vocab_size, 0).batches(
        shape.global_batch, shape.seq_len, steps))
    losses, walls = {}, {}
    with MainPath(specs, records, ("flash_attention",)) as mp:
        for dev in (CARD, "cpu"):
            tr = Trainer(cfg, ParallelConfig(), shape, optimizer_for(steps),
                         device=dev)
            (_, losses[dev]), walls[dev] = wall(lambda: tr.fit(
                batches, steps, tr.state_from_jax(host), log_every=0))
    counts = mp.counts()
    if counts["flash_attention"] != cfg.n_layers * steps:
        raise AssertionError(f"flash_attention launched "
                             f"{counts['flash_attention']} times in {steps} "
                             f"steps of {cfg.n_layers} layers")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[CARD],
                                                   losses["cpu"]))
    if rel > TRAIN_CPU_GPU_RTOL:
        raise AssertionError(f"card and CPU losses differ by {rel} relative")
    return {"preset": "ci", "steps": steps, "tf32": False,
            "losses_cuda": losses[CARD], "losses_cpu": losses["cpu"],
            "max_rel_diff": rel, "tolerance": TRAIN_CPU_GPU_RTOL,
            "wall_s": walls, "launches": counts}


def phase_train_task(specs, records):
    """train_lm.train_task (the ci preset) as a task on the thread executor
    with a checkpoint root: it saves every TASK_CKPT_EVERY steps through
    comm.checkpoint and its first attempt raises after step TASK_FAIL_AT;
    the retry must resume from the last save and finish.  The session's
    trace goes through the port's Perfetto export."""
    import os
    import tempfile
    from repro_torch.core import (ResourceManager, SchedulerSession,
                                  TaskDescription, TaskState,
                                  ThreadExecutor, logical_devices)
    from repro_torch.obs import export_perfetto, load_trace
    from repro_torch.train_lm import model_for, train_task
    steps, every, fail = TASK_STEPS, TASK_CKPT_EVERY, TASK_FAIL_AT
    with tempfile.TemporaryDirectory() as root:
        trace = os.path.join(root, "train_task.jsonl")
        sess = SchedulerSession(
            ThreadExecutor(build_comm=False, tick=0.01),
            ResourceManager(logical_devices(1, CARD)), tick=0.01,
            ckpt_root=os.path.join(root, "ckpt"), trace_path=trace)
        with MainPath(specs, records, ("flash_attention",)) as mp:
            rep, s = wall(lambda: sess.run([TaskDescription(
                name="train", ranks=1, fn=train_task, max_retries=1,
                kwargs=dict(preset="ci", steps=steps, ckpt_every=every,
                            fail_at=fail, device=CARD),
                tags={"pipeline": "train"})], timeout=600))
        doc = export_perfetto(load_trace(trace),
                              os.path.join(root, "train_task.trace.json"))
    counts = mp.counts()
    task = rep.tasks[0]
    want_resume = fail // every * every
    if task.state != TaskState.DONE or rep.n_retries != 1 or \
            task.resumed_from_step != want_resume or \
            task.result["start_step"] != want_resume or \
            task.result["step"] != steps:
        raise AssertionError(f"train task: {task.state} {task.error}, "
                             f"{rep.n_retries} retries, resumed from "
                             f"{task.resumed_from_step}")
    # the first attempt's steps and the retry's, one launch a layer each
    want = model_for("ci")[0].n_layers * (fail + steps - want_resume)
    if counts["flash_attention"] != want:
        raise AssertionError(f"train_task: flash_attention launched "
                             f"{counts['flash_attention']} times, not {want}")
    ev = doc["traceEvents"]
    return {"steps": steps, "ckpt_every": every, "failed_after": fail,
            "retries": rep.n_retries,
            "resumed_from_step": task.resumed_from_step,
            "resume_events": len(rep.events("resume")), "wall_s": s,
            "losses_after_resume": task.result["losses"],
            "perfetto": {"events": len(ev),
                         "task_slices": sum(e["ph"] == "X" and
                                            e.get("cat") == "task"
                                            for e in ev),
                         "instants": sum(e["ph"] == "i" for e in ev)},
            "launches": counts}


# ---------------------------------------------------------------------------
# the distributed layer: a mesh of logical ranks on one card
# ---------------------------------------------------------------------------
def _unsharded(tr, state) -> dict:
    """A sharded trainer's state as whole tensors in the JAX layout, on
    the card (the trainer's own ``state_tree`` puts them on the host)."""
    from repro_torch.distributed.sharding import nest_paths, unshard_tree
    specs, o = tr.bundle.info["pspecs"], state.opt_state

    def whole(ranks):
        return nest_paths(unshard_tree(ranks, specs, tr.mesh, CARD))
    return {"params": whole(state.params),
            "opt": {"mu": whole([r["mu"] for r in o]),
                    "nu": whole([r["nu"] for r in o]),
                    "count": o[0]["count"]}}


def _state_equal(tr, state, saved: dict) -> bool:
    """A trainer's state against ``saved`` (``_unsharded``'s tree) bit for
    bit, leaf by leaf on the card: a mesh's blocks unsharded one leaf at a
    time, a one-rank state's tensors against their slices of the leaves."""
    from repro_torch.distributed.sharding import flat_paths, unshard
    from repro_torch.models.convert import named_from_jax
    o = state.opt_state
    if tr.mesh is None:
        pairs = [(dict(state.params.named_parameters()),
                  named_from_jax(saved["params"], tr.cfg))] + [
            (o[m], named_from_jax(saved["opt"][m], tr.cfg))
            for m in ("mu", "nu")]
        return int(o["count"]) == int(saved["opt"]["count"]) and all(
            torch.equal(t, want[k]) for named, want in pairs
            for k, t in named.items())
    specs = tr.bundle.info["pspecs"]
    pairs = [(state.params, flat_paths(saved["params"]))] + [
        ([r[m] for r in o], flat_paths(saved["opt"][m])) for m in ("mu", "nu")]
    return all(int(r["count"]) == int(saved["opt"]["count"]) for r in o) \
        and all(torch.equal(unshard([r[path] for r in ranks], spec, tr.mesh,
                                    name=path), want[path])
                for ranks, want in pairs for path, spec in specs.items())


def _rank_bytes(state, info, grid) -> dict:
    """Each rank's bytes of parameters and of moments, against its share:
    each leaf's bytes (its shape in the JAX layout) over the number of
    ranks its spec splits it across, a replicated leaf whole."""
    sizes = dict(zip(("data", "model"), grid))

    def nbytes(t):
        return t.numel() * t.element_size()
    share = {"params": 0, "moments": 0}
    for path, spec in info["pspecs"].items():
        split = 1
        for e in spec:
            for a in (() if e is None else (e,) if isinstance(e, str)
                      else e):
                split *= sizes[a]
        n = int(np.prod(info["layout"][path][0])) // split
        share["params"] += n * state.params[0][path].element_size()
        share["moments"] += 2 * 4 * n            # mu and nu, f32
    ranks = [{"params": sum(nbytes(t) for t in p.values()),
              "moments": sum(nbytes(t) for t in list(o["mu"].values())
                             + list(o["nu"].values()))}
             for p, o in zip(state.params, state.opt_state)]
    if any(r != share for r in ranks):
        raise AssertionError(f"rank bytes {ranks}, not the share {share}")
    return {"per_rank": ranks, "share": share}


def phase_train_dist(specs, records):
    """qwen3-8b at its published widths in bf16, TRAIN_QWEN3_LAYERS of its
    layers, on a DIST_GRID mesh of logical ranks of cuda:0, the model axis
    splitting compute, TRAIN_STEPS steps on one batch of DIST_BATCH x
    TRAIN_SEQ tokens: the loss falls, flash_attention once per layer per
    forward per (data, model) rank (twice under remat), peak memory under
    80 GB, each rank's bytes its share, each model rank's working slice
    the dry run's; one more step profiled, and one more traced for the
    device time of its model-rank sums.  Then the
    step's checkpoint restored onto each of DIST_RESTORE_GRIDS bit-equal,
    and one step on (1, 4)."""
    import dataclasses
    import tempfile
    from repro_torch.configs import ParallelConfig, ShapeConfig, get_config
    from repro_torch.distributed.context import SUM_RANGE
    from repro_torch.distributed.sharding import flat_paths
    from repro_torch.launch.dryrun import step_bytes
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import make_concrete_batch, train_batch_shapes
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer
    cfg = dataclasses.replace(get_config(SERVE_ARCH),
                              n_layers=TRAIN_QWEN3_LAYERS)
    steps, grid = TRAIN_STEPS, DIST_GRID
    shape = ShapeConfig("t", "train", TRAIN_SEQ, DIST_BATCH)
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=steps)
    batch = make_concrete_batch(train_batch_shapes(cfg, DIST_BATCH,
                                                   TRAIN_SEQ),
                                np.random.default_rng(0), cfg.vocab_size,
                                CARD)

    def trainer(g):
        return Trainer(cfg, ParallelConfig(), shape, ocfg,
                       mesh=make_local_mesh(*g, device=CARD), ckpt_dir=ckdir)
    remat = 2 if cfg.remat else 1
    per_step = cfg.n_layers * grid[0] * grid[1] * remat
    # one model rank's working slice and its f32 accumulator, by the dry
    # run's arithmetic for this cell
    dry_working = step_bytes(cfg, shape, make_local_mesh(
        *grid, device="meta"), ParallelConfig())[0]["working_bytes"]
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckdir:
        tr = trainer(grid)
        with MainPath(specs, records, ("flash_attention",)) as mp:
            state, init_s = wall(tr.init_state)
            stamps = {}
            (state, losses), fit_s = wall(lambda: tr.fit(
                [batch] * steps, steps, state, log_every=0,
                on_metrics=_step_times(stamps)))
        counts = mp.counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if counts["flash_attention"] != per_step * steps:
            raise AssertionError(f"flash_attention launched "
                                 f"{counts['flash_attention']} times in "
                                 f"{steps} steps of {per_step}")
        if not (losses[-1] < losses[0] and np.all(np.isfinite(losses))):
            raise AssertionError(f"the loss did not fall: {losses}")
        if peak_gb >= 80:
            raise AssertionError(f"train_dist: a step's peak is {peak_gb} GB")
        rank_bytes = _rank_bytes(state, tr.bundle.info, grid)
        # the trainer's save: unsharded onto the host, then written
        tree, unshard_s = wall(lambda: tr.state_tree(state))
        _, save_s = wall(lambda: ckpt.save(ckdir, steps, tree,
                                           async_=False))
        n_params = sum(t.numel() for t in flat_paths(tree["params"])
                       .values())
        del tree
        saved = _unsharded(tr, state)
        # one more step under the profiler, and one more traced for the
        # model-rank sums (their results dropped: the state stays the
        # saved step's)
        prof = profile(lambda: tr.bundle.fn(state.params, state.opt_state,
                                            batch))
        step_sums = range_device_ms(lambda: tr.bundle.fn(
            state.params, state.opt_state, batch), SUM_RANGE)
        slices = _slice_bytes(tr.bundle.info["working"](
            torch.device("meta")), acc=True)
        if any(b != dry_working for b in slices):
            raise AssertionError(f"working slices and accumulators of "
                                 f"{slices} bytes, the dry run's "
                                 f"{dry_working}")
        del state, tr
        free_device_memory()
        restores = []
        for g in DIST_RESTORE_GRIDS:
            tr2 = trainer(g)
            back, restore_s = wall(tr2.maybe_restore)
            equal = back.step == steps and _state_equal(tr2, back, saved)
            if not equal:
                raise AssertionError(f"the restore onto {g} differs from "
                                     f"step {steps}'s state")
            rec = {"grid": list(g), "restore_s": restore_s,
                   "bit_equal": equal}
            if g == (1, 4):
                with MainPath(specs, records, ("flash_attention",)) as mp2:
                    (_, more), step_s = wall(lambda: tr2.fit(
                        [batch], 1, back, log_every=0))
                if not np.isfinite(more[0]):
                    raise AssertionError(f"the step on {g}: {more}")
                rec.update(step_loss=more[0], step_s=step_s,
                           launches=mp2.counts())
            restores.append(rec)
            del back, tr2
            free_device_memory()
    del saved
    free_device_memory()
    step_ms = _step_ms(stamps["t"])
    return {"arch": SERVE_ARCH, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
            "mesh": list(grid), "ranks_on": CARD,
            "batch": DIST_BATCH, "seq": TRAIN_SEQ,
            "rows_per_data_rank": DIST_BATCH // grid[0],
            "param_count": n_params, "init_s": init_s, "fit_s": fit_s,
            "losses": losses, "step_ms": step_ms,
            "tokens_per_s": DIST_BATCH * TRAIN_SEQ / step_ms * 1e3,
            "peak_gb": peak_gb, "rank_bytes": rank_bytes,
            "working_gb_per_model_rank": [b / 1e9 for b in slices],
            "dry_run_working_gb": dry_working / 1e9,
            "model_rank_sums": {"step": step_sums},
            "flash_attention_launches_per_step": per_step,
            "profile_step": prof, "unshard_s": unshard_s, "save_s": save_s,
            "restores": restores, "launches": counts}


def phase_train_dist_f32(specs, records):
    """qwen3-8b's widths with DIST_F32_LAYERS layers in float32 (TF32 off):
    the same parameters and batches to a DIST_GRID trainer (the model axis
    splitting compute), to one with tensor_parallel=False and to a
    one-rank trainer, DIST_F32_STEPS steps: each mesh's losses within
    DIST_F32_RTOL relative of one rank's."""
    import dataclasses
    from repro_torch.configs import ParallelConfig, ShapeConfig, get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import (get_model, make_concrete_batch,
                                    train_batch_shapes)
    from repro_torch.models.convert import jax_tree
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(SERVE_ARCH),
                              n_layers=DIST_F32_LAYERS, dtype="float32")
    steps, grid = DIST_F32_STEPS, DIST_GRID
    shape = ShapeConfig("t", "train", TRAIN_SEQ, DIST_BATCH)
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=steps)
    gen = torch.Generator(device=CARD)
    gen.manual_seed(1)
    model = get_model(cfg).init(gen, cfg)
    tree = jax_tree(dict(model.named_parameters()), cfg)
    del model
    batches = [make_concrete_batch(train_batch_shapes(cfg, DIST_BATCH,
                                                      TRAIN_SEQ),
                                   np.random.default_rng(i), cfg.vocab_size,
                                   CARD) for i in range(steps)]
    runs = {"split": (grid, ParallelConfig()),
            "tensor_parallel_off": (grid, ParallelConfig(
                tensor_parallel=False)),
            "one_rank": ((1, 1), ParallelConfig())}
    losses, walls = {}, {}
    free_device_memory()
    with MainPath(specs, records, ("flash_attention",)) as mp:
        for k, (g, parallel) in runs.items():
            tr = Trainer(cfg, parallel, shape, ocfg,
                         mesh=make_local_mesh(*g, device=CARD))
            # the state is dropped with the trainer: two runs' states and
            # moments at once would not fit beside the third's step
            losses[k], walls[k] = wall(lambda: tr.fit(
                batches, steps, tr.state_from_jax(tree), log_every=0)[1])
            del tr
            free_device_memory()
    counts = mp.counts()
    want = steps * cfg.n_layers * (grid[0] * grid[1] + grid[0] + 1) \
        * (2 if cfg.remat else 1)
    if counts["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched "
                             f"{counts['flash_attention']} times, not {want}")
    rel = {k: max(abs(a - b) / abs(b) for a, b in zip(losses[k],
                                                       losses["one_rank"]))
           for k in ("split", "tensor_parallel_off")}
    if max(rel.values()) > DIST_F32_RTOL:
        raise AssertionError(f"the meshes' losses differ by {rel} relative")
    return {"arch": SERVE_ARCH, "n_layers": cfg.n_layers, "dtype": "float32",
            "tf32": False, "mesh": list(grid), "batch": DIST_BATCH,
            "seq": TRAIN_SEQ, "steps": steps,
            "losses_mesh": losses["split"],
            "losses_tensor_parallel_off": losses["tensor_parallel_off"],
            "losses_one_rank": losses["one_rank"],
            "max_rel_diff": rel, "tolerance": DIST_F32_RTOL,
            "wall_s": walls, "launches": counts}


def phase_moe_ep(gen) -> dict:
    """One MoE layer at qwen2-moe's widths in f32 (TF32 off), cf 1.25, on
    EP_TOKENS tokens drawn around one shared vector (so that pairs drop):
    moe_ffn_shardmap on a DIST_GRID mesh against moe_ffn run on each data
    shard alone, within EP_RTOL of the largest |output|."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import axes_ctx
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config(MOE_ARCH), dtype="float32")
    mesh = make_local_mesh(*DIST_GRID, device=CARD)
    p = moe.moe_init(gen, cfg, torch.float32)
    x = torch.randn((EP_TOKENS, cfg.d_model), generator=gen, device=CARD)         + torch.randn((cfg.d_model,), generator=gen, device=CARD)
    shards = x.split(EP_TOKENS // DIST_GRID[0])

    def ep():
        with axes_ctx(mesh, "shardmap"):
            return moe.moe_ffn(p, x, cfg)

    def per_shard():
        return torch.cat([moe.moe_ffn(p, s, cfg) for s in shards])
    with torch.inference_mode():
        got, want = ep(), per_shard()
        err, scale = float((got - want).abs().max()),             float(want.abs().max())
        if not err <= EP_RTOL * scale:
            raise AssertionError(f"moe_ffn_shardmap is {err} from moe_ffn "
                                 f"per data shard (largest |out| {scale})")
        cap = moe.capacity(len(shards[0]), cfg)
        dropped = 0
        for s in shards:
            idx, _ = moe.route(p, s, cfg)
            _, pos = moe.dispatch_indices(idx, cfg.n_experts, cap)
            dropped += int((pos >= cap).sum())
        ms, plain_ms = time_ms(ep, reps=10), time_ms(per_shard, reps=10)
    pairs = EP_TOKENS * cfg.top_k
    return {"arch": MOE_ARCH, "dtype": "float32", "mesh": list(DIST_GRID),
            "tokens": EP_TOKENS, "capacity_factor": cfg.capacity_factor,
            "capacity_per_shard": cap, "experts_per_model_rank":
            cfg.n_experts // DIST_GRID[1], "pairs": pairs,
            "pairs_dropped": dropped, "dropped_share": dropped / pairs,
            "max_abs_err": err, "max_abs_out": scale,
            "tolerance": f"{EP_RTOL} x max |out|", "ms": ms,
            "per_shard_moe_ffn_ms": plain_ms}


def phase_compress(gen) -> dict:
    """compressed_psum_mean over N_RANKS logical ranks of cuda:0 on
    COMPRESS_SHAPE f32 tensors: the mean within COMPRESS_RTOL of the exact
    mean's largest magnitude; each rank's x + e_old - e_new equal to its
    dequantised value; a second call fed the errors within the bound."""
    from repro_torch.core import logical_devices
    from repro_torch.distributed import compression as cp
    devices = logical_devices(N_RANKS, CARD)
    xs = [torch.randn(COMPRESS_SHAPE, generator=gen, device=CARD)
          for _ in devices]
    exact = torch.stack(xs).mean(0)
    top = float(exact.abs().max())
    out, errs = {}, None
    for call in (1, 2):
        old = errs if errs is not None else [None] * len(xs)
        means, errs = cp.compressed_psum_mean(xs, devices, errs)
        rel = float((means[0] - exact).abs().max()) / top
        if not rel <= COMPRESS_RTOL or not all(torch.equal(m, means[0])
                                               for m in means):
            raise AssertionError(f"call {call}: the compressed mean is {rel}"
                                 f" from the exact mean")
        for x, e0, e1 in zip(xs, old, errs):
            xe = x + (e0 if e0 is not None else 0.0)
            if not torch.equal(xe - e1, cp.dequantize_int8(
                    *cp.quantize_int8(xe))):
                raise AssertionError(f"call {call}: x + e_old - e_new is not"
                                     f" the dequantised value")
        out[f"call_{call}_rel_err"] = rel
    ms = time_ms(lambda: cp.compressed_psum_mean(xs, devices, errs), reps=10)
    plain_ms = time_ms(lambda: torch.stack(xs).mean(0), reps=10)
    n = xs[0].numel()
    return {"shape": list(COMPRESS_SHAPE), "ranks": N_RANKS, **out,
            "tolerance": COMPRESS_RTOL, "ms": ms, "exact_mean_ms": plain_ms,
            "wire_bytes_per_rank": cp.wire_bytes(xs[0]),
            "f32_bytes_per_rank": 4 * n,
            "wire_ratio": cp.wire_bytes(xs[0]) / (4 * n)}


def _nbytes(blocks: dict) -> int:
    return sum(t.numel() * t.element_size() for t in blocks.values())


def _dist_shapes() -> dict:
    """serve_dist's prefill and decode cells: SERVE_DIST_ROWS rows of
    SERVE_DIST_PROMPT + SERVE_DIST_NEW positions."""
    from repro_torch.configs import ShapeConfig
    n = SERVE_DIST_PROMPT + SERVE_DIST_NEW
    return {k: ShapeConfig("serve_dist", k, n, SERVE_DIST_ROWS)
            for k in ("prefill", "decode")}


def _dry_runs(cfg, shapes: dict) -> dict:
    """The dry run's record of each cell on a DIST_GRID mesh of ``meta``
    ranks (launch/dryrun.py)."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_local_mesh
    meta = make_local_mesh(*DIST_GRID, device="meta")
    return {k: run_cell(SERVE_ARCH, s, cfg=cfg, mesh=meta, verbose=False)
            for k, s in shapes.items()}


def _greedy_feed(logits, info, mesh, position: int) -> dict:
    """The next decode batch: each row's argmax of the logits unsharded
    from the ranks' blocks, written at ``position``."""
    from repro_torch.distributed.sharding import unshard
    whole = unshard(logits, info["logit_spec"], mesh)
    return {"tokens": whole.argmax(-1, keepdim=True).to(torch.int32),
            "positions": torch.full((whole.shape[0],), position,
                                    dtype=torch.int32, device=whole.device)}


def _slice_bytes(work, acc: bool = False) -> list:
    """Each model rank's working slice, in bytes (``acc``: with an f32
    gradient accumulator of the same shapes)."""
    return [sum(t.numel() * (t.element_size() + 4 * acc)
                for t in m.parameters()) for m in work.slices]


def phase_serve_dist(specs, records):
    """qwen3-8b whole at its published widths in bf16, sharded by
    shard_model onto a DIST_GRID mesh of logical ranks of cuda:0, the
    model axis splitting compute (heads, ff columns, vocabulary):
    make_prefill_step on SERVE_DIST_ROWS prompts of SERVE_DIST_PROMPT
    tokens (timed SERVE_DIST_PREFILLS times, then once profiled and once
    traced for the device time of its model-rank sums), then
    SERVE_DIST_NEW greedy steps of make_decode_step on its blocks (the last
    one profiled, then run again, traced, for its sums: a decode step
    writes the same cache rows each time).  Each rank's bytes and each
    model rank's working
    slice equal the dry run's for the same cells, flash_attention once per
    layer per (data, model) rank a prefill step, peak under 80 GB."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.distributed.context import SUM_RANGE
    from repro_torch.distributed.steps import (gather_model,
                                               make_decode_step,
                                               make_prefill_step,
                                               shard_model)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import make_concrete_batch, prefill_batch_shapes
    cfg = get_config(SERVE_ARCH)
    shapes = _dist_shapes()
    dry = _dry_runs(cfg, shapes)
    mesh = make_local_mesh(*DIST_GRID, device=CARD)
    prefill = make_prefill_step(cfg, mesh, ParallelConfig(),
                                shapes["prefill"])
    decode = make_decode_step(cfg, mesh, ParallelConfig(), shapes["decode"])
    free_device_memory()
    model = serve_model(cfg)
    params = shard_model(model, prefill.info, mesh)
    del model
    free_device_memory()
    batch = make_concrete_batch(prefill_batch_shapes(
        cfg, SERVE_DIST_ROWS, SERVE_DIST_PROMPT), np.random.default_rng(0),
        cfg.vocab_size, CARD)
    per_step = cfg.n_layers * DIST_GRID[0] * DIST_GRID[1]
    torch.cuda.reset_peak_memory_stats()
    with MainPath(specs, records, ("flash_attention",)) as mp:
        prefill_s = []
        for _ in range(SERVE_DIST_PREFILLS):
            cache = logits = None
            (cache, logits), s = wall(lambda: prefill.fn(params, batch))
            prefill_s.append(s)
        # one more prefill step under the profiler, and one more traced
        # for the model-rank sums (their results dropped)
        prof_prefill = profile(lambda: prefill.fn(params, batch))
        prefill_sums = range_device_ms(lambda: prefill.fn(params, batch),
                                       SUM_RANGE)
        prefill_launches = mp.counts()["flash_attention"]
        decode_s, tokens, out = [], [], {}
        for t in range(SERVE_DIST_NEW):
            feed = _greedy_feed(logits, prefill.info, mesh,
                                SERVE_DIST_PROMPT + t)
            tokens.append(feed["tokens"][:, 0].tolist())
            if t < SERVE_DIST_NEW - 1:
                (logits, cache), s = wall(lambda: decode.fn(params, feed,
                                                            cache))
                decode_s.append(s)
            else:                     # the last step under the profiler
                prof_decode = profile(lambda: out.update(
                    step=decode.fn(params, feed, cache)))
                decode_sums = range_device_ms(
                    lambda: decode.fn(params, feed, cache), SUM_RANGE)
                logits, cache = out.pop("step")
    counts = mp.counts()
    peak = torch.cuda.max_memory_allocated()
    if prefill_launches != per_step * (SERVE_DIST_PREFILLS + 2) or \
            counts["flash_attention"] != prefill_launches:
        raise AssertionError(f"flash_attention launched {prefill_launches} "
                             f"times in {SERVE_DIST_PREFILLS + 2} prefill "
                             f"steps of {per_step}, "
                             f"{counts['flash_attention']} in all")
    whole = torch.stack([torch.as_tensor(x) for x in tokens])
    if not (whole.min() >= 0 and whole.max() < cfg.vocab_size) or \
            not all(torch.isfinite(x).all() for x in logits):
        raise AssertionError("serve_dist: logits not finite or tokens out "
                             "of the vocabulary")
    if peak >= 80e9:
        raise AssertionError(f"serve_dist: peak {peak / 1e9} GB")
    # each rank's bytes against the dry run's
    ranks = [{"params": _nbytes(p), "cache": _nbytes(c),
              "batch": _nbytes({k: v.chunk(DIST_GRID[0])[0]
                                for k, v in feed.items()})}
             for p, c in zip(params, cache)]
    logit_bytes = [x.numel() * x.element_size() for x in logits]
    dp, dd = dry["prefill"]["memory"], dry["decode"]["memory"]
    for r, lb in zip(ranks, logit_bytes):
        if r["params"] + r["cache"] + r["batch"] != dd["argument_bytes"] or \
                r["params"] != dp["argument_parts"]["params"] or \
                r["cache"] + lb != dp["output_bytes"]:
            raise AssertionError(f"rank bytes {r} (logits {lb}), the dry run"
                                 f" {dd['argument_parts']} and "
                                 f"{dp['output_parts']}")
    # the gather alone: the working slices filled from every rank's blocks
    info = prefill.info
    work = info["working"](torch.device(CARD))
    slice_bytes = _slice_bytes(work)
    if any(b != dp["working_bytes"] for b in slice_bytes):
        raise AssertionError(f"working slices of {slice_bytes} bytes, the "
                             f"dry run's {dp['working_bytes']}")

    def gather_all():
        for m, model in enumerate(work.slices):
            gather_model(model, params, info["layout"], info["pspecs"],
                         mesh, info["slices"], m)
    gather_s = [wall(gather_all)[1] for _ in range(3)]
    del work, params, cache, logits
    free_device_memory()
    temp = max(dp["temp_bytes"], dd["temp_bytes"])
    return {"arch": SERVE_ARCH, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
            "mesh": list(DIST_GRID), "ranks_on": CARD,
            "rows": SERVE_DIST_ROWS, "prompt": SERVE_DIST_PROMPT,
            "cell_positions": shapes["decode"].seq_len,
            "new_tokens": SERVE_DIST_NEW,
            "prefill_ms": statistics.median(prefill_s) * 1e3,
            "prefill_ms_each": [x * 1e3 for x in prefill_s],
            "decode_ms": statistics.median(decode_s) * 1e3,
            "decode_ms_first_last": [decode_s[0] * 1e3, decode_s[-1] * 1e3],
            "gather_ms": statistics.median(gather_s) * 1e3,
            "working_gb_per_model_rank": [b / 1e9 for b in slice_bytes],
            "dry_run_working_gb": dp["working_bytes"] / 1e9,
            "model_rank_sums": {"prefill": prefill_sums,
                                "decode": decode_sums},
            "peak_gb": peak / 1e9,
            "rank_bytes": ranks[0], "rank_bytes_equal_dry_run": True,
            "dry_run": {k: {"argument_bytes": v["memory"]["argument_bytes"],
                            "working_bytes": v["memory"]["working_bytes"],
                            "temp_bytes": v["memory"]["temp_bytes"],
                            "flops_per_rank": v["flops_per_rank"],
                            "all_gather_bytes": v["collectives"]["per_op"][
                                "all-gather"]["traffic_bytes"],
                            "pass_s": v["timing"]["pass_s"]}
                        for k, v in dry.items()},
            "predicted_gb_per_device": (dd["argument_bytes"]
                                        + dd["working_bytes"] + temp) / 1e9,
            # the card holds every rank's blocks and one working slice a
            # model rank
            "predicted_gb_this_card": (mesh.size * dd["argument_bytes"]
                                       + DIST_GRID[1] * dd["working_bytes"]
                                       + temp) / 1e9,
            "flash_attention_launches_per_prefill": per_step,
            "attention_shape_per_rank": [SERVE_DIST_ROWS // DIST_GRID[0],
                                         cfg.n_heads // DIST_GRID[1],
                                         cfg.n_kv_heads // DIST_GRID[1],
                                         SERVE_DIST_PROMPT, cfg.head_dim],
            "profile_prefill_step": prof_prefill,
            "profile_decode_step": prof_decode,
            "tokens_row0": whole[:, 0].tolist(), "launches": counts}


def _dist_against_one_rank(cfg, parallel, gen_seed: int) -> dict:
    """``cfg`` in f32 on a DIST_GRID mesh and on one rank from the same
    weights and prompts: SERVE_DIST_F32_NEW greedy steps after the
    prefill; tokens equal, logits within SERVE_DIST_F32_RTOL of the
    largest |logit| at every step."""
    from repro_torch.distributed.sharding import unshard
    from repro_torch.distributed.steps import (make_decode_step,
                                               make_prefill_step,
                                               shard_model)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import (get_model, make_concrete_batch,
                                    prefill_batch_shapes)
    shapes = _dist_shapes()
    mesh = make_local_mesh(*DIST_GRID, device=CARD)
    (prefill, decode), (prefill1, decode1) = (
        (make_prefill_step(cfg, m, parallel, shapes["prefill"]),
         make_decode_step(cfg, m, parallel, shapes["decode"]))
        for m in (mesh, None))
    gen = torch.Generator(device=CARD)
    gen.manual_seed(gen_seed)
    model = get_model(cfg).init(gen, cfg)
    params = shard_model(model, prefill.info, mesh)
    batch = make_concrete_batch(prefill_batch_shapes(
        cfg, SERVE_DIST_ROWS, SERVE_DIST_PROMPT), np.random.default_rng(1),
        cfg.vocab_size, CARD)
    cache, logits = prefill.fn(params, batch)
    one_cache, one = prefill1.fn(model, batch)
    worst, tokens = 0.0, []
    for t in range(SERVE_DIST_F32_NEW + 1):
        whole = unshard(logits, prefill.info["logit_spec"], mesh)
        worst = max(worst, float((whole - one).abs().max())
                    / float(one.abs().max()))
        if not torch.equal(whole.argmax(-1), one.argmax(-1)):
            raise AssertionError(f"step {t}: the mesh's tokens "
                                 f"{whole.argmax(-1).tolist()} are not one "
                                 f"rank's {one.argmax(-1).tolist()}")
        tokens.append(one.argmax(-1).tolist())
        if t == SERVE_DIST_F32_NEW:
            break
        feed = _greedy_feed(logits, prefill.info, mesh,
                            SERVE_DIST_PROMPT + t)
        logits, cache = decode.fn(params, feed, cache)
        one, one_cache = decode1.fn(model, feed, one_cache)
    if worst > SERVE_DIST_F32_RTOL:
        raise AssertionError(f"the mesh's logits are {worst} of the largest "
                             f"|logit| from one rank's")
    del model, params, cache, one_cache
    free_device_memory()
    return {"max_rel_diff": worst, "tokens_equal": True,
            "tokens_row0": [t[0] for t in tokens]}


def phase_serve_dist_f32(specs, records):
    """qwen3-8b's widths at 2 layers in float32 (TF32 off) through the
    sharded prefill and decode steps on a DIST_GRID mesh against one
    rank's prefill and decode_step from the same weights, the model axis
    splitting compute and, again, with tensor_parallel=False (whole
    working models); then qwen2-moe-a2.7b at 2 layers under
    moe_impl="shardmap" at the capacity factor n_experts / top_k (no pair
    drops) the same way, its KV cache in the superblock layout."""
    import dataclasses
    from repro_torch.configs import ParallelConfig, get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dense = dataclasses.replace(get_config(SERVE_ARCH), n_layers=2,
                                dtype="float32")
    moe = get_config(MOE_ARCH)
    moe = dataclasses.replace(moe, n_layers=2, dtype="float32",
                              capacity_factor=moe.n_experts / moe.top_k)
    free_device_memory()
    with MainPath(specs, records, ("flash_attention",)) as mp:
        res = {"dense": _dist_against_one_rank(dense, ParallelConfig(), 1),
               "dense_tensor_parallel_off": _dist_against_one_rank(
                   dense, ParallelConfig(tensor_parallel=False), 1),
               "moe_shardmap": _dist_against_one_rank(
                   moe, ParallelConfig(moe_impl="shardmap"), 2)}
    counts = mp.counts()
    # each prefill: once a layer on each (data, model) rank (on each data
    # rank where the model axis does not split), and once a layer on one
    # rank; both models' heads split over DIST_GRID[1]
    ranks = DIST_GRID[0] * DIST_GRID[1]
    want = 2 * ((ranks + 1) * 2 + DIST_GRID[0] + 1)
    if counts["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched "
                             f"{counts['flash_attention']} times, not {want}")
    return {"archs": [SERVE_ARCH, MOE_ARCH], "n_layers": 2,
            "dtype": "float32", "tf32": False, "mesh": list(DIST_GRID),
            "rows": SERVE_DIST_ROWS, "prompt": SERVE_DIST_PROMPT,
            "new_tokens": SERVE_DIST_F32_NEW,
            "moe_capacity_factor": moe.capacity_factor,
            "tolerance": f"{SERVE_DIST_F32_RTOL} x max |logit|", **res,
            "launches": counts}


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
    thread_makespans = res["makespan_s"]
    one = build_communicator(logical_devices(1, "cuda:0"))
    with MainPath(specs, records, radix) as mp:
        res = phase_shuffle(one, rng)
    emit("shuffle", launches=mp.counts(), **res)
    # the workers launch the kernel; this process launches nothing here
    with MainPath(specs, records, ()) as mp:
        res = phase_process(records, thread_makespans)
    emit("process", launches=mp.counts(), **res)

    res = run_serve(SERVE_ARCH, specs, records, radix + attention)
    emit("serve", **res)
    with MainPath(specs, records, attention) as mp:
        res = phase_serve_f32(SERVE_ARCH)
    emit("serve_f32", launches=mp.counts(), **res)

    held = {}
    res = run_serve(SSM_ARCH, specs, records, radix + scan, hold=held)
    emit("serve_ssm", **res)
    emit("serve_ssm_bf16", **phase_serve_ssm_bf16(specs, records,
                                                  held.pop("params"), res))
    with MainPath(specs, records, scan) as mp:
        res = phase_serve_f32(SSM_ARCH)
    emit("serve_ssm_f32", launches=mp.counts(), **res)

    res = run_serve(MOE_ARCH, specs, records, radix + attention,
                    extra=moe_drop_shares)
    emit("serve_moe", **res)
    with MainPath(specs, records, attention) as mp:
        res = phase_serve_moe_f32(gen)
    emit("serve_moe_f32", launches=mp.counts(), **res)
    emit("serve_llama4", **phase_serve_llama4(specs, records))

    res = run_serve(VLM_ARCH, specs, records, radix + attention)
    emit("serve_vlm", **res)
    with MainPath(specs, records, attention) as mp:
        res = phase_serve_f32(VLM_ARCH)
    emit("serve_vlm_f32", launches=mp.counts(), **res)
    res = run_serve(AUDIO_ARCH, specs, records, radix + attention,
                    traffic=AUDIO_TRAFFIC)
    emit("serve_audio", **res)
    with MainPath(specs, records, attention) as mp:
        res = phase_serve_f32(AUDIO_ARCH, n_encoder_layers=2)
    emit("serve_audio_f32", launches=mp.counts(), **res)

    res = run_serve(HYBRID_ARCH, specs, records, radix + attention + scan)
    emit("serve_hybrid", **res)
    with MainPath(specs, records, attention + scan) as mp:
        res = phase_serve_f32(HYBRID_ARCH, **HYBRID_F32)
    emit("serve_hybrid_f32", launches=mp.counts(), **res)

    free_device_memory()
    emit("train_etl", **phase_train_etl(specs, records, gen))
    emit("train_qwen3", **phase_train_qwen3(specs, records, gen))
    emit("train_moe", **phase_train_moe(specs, records))
    emit("train_ssm", **phase_train_ssm(specs, records, gen))
    emit("train_vlm", **phase_train_full_depth(specs, records, VLM_ARCH,
                                               TRAIN_SEQ))
    emit("train_audio", **phase_train_full_depth(specs, records, AUDIO_ARCH,
                                                 AUDIO_TEXT_CTX))
    emit("train_hybrid", **phase_train_hybrid(specs, records, gen))
    emit("train_cpu_gpu", **phase_train_cpu_gpu(specs, records))
    emit("train_task", **phase_train_task(specs, records))

    free_device_memory()
    emit("train_dist", **phase_train_dist(specs, records))
    emit("train_dist_f32", **phase_train_dist_f32(specs, records))
    with MainPath(specs, records, ()) as mp:
        res = phase_moe_ep(gen)
    emit("moe_ep", launches=mp.counts(), **res)
    with MainPath(specs, records, ()) as mp:
        res = phase_compress(gen)
    emit("compress", launches=mp.counts(), **res)
    emit("serve_dist", **phase_serve_dist(specs, records))
    emit("serve_dist_f32", **phase_serve_dist_f32(specs, records))

    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
