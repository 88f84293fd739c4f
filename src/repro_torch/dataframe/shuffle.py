"""Out-of-core peer-to-peer shuffle: the paper's shuffle-heavy operators
(`dist_sort`, `dist_join`) at row counts that no longer fit the in-memory
``ops_dist`` path (Radical-Cylon's 35M/3.5B-row claim surface).

Pipeline, per task part (one per worker):

  1. **local bucketing** — :func:`radix_bucket` wires the CUDA
     ``radix_partition`` kernel in as the packing stage: one kernel call
     yields bucket-major stable destinations + histogram, one gather lays
     the columns out bucket-major, and each destination's bucket is a
     CONTIGUOUS slice of that layout.  This replaces the argsort-based
     ``_local_shuffle_pack`` on this path — no (P, send_cap) padded send
     buffer, no fixed capacity, no overflow case.
  2. **exchange** — ``comm.all_to_all_arrays`` ships each bucket to its
     destination part (the process executor's raw-buffer peer frames, a
     later slice of the port); a single-part comm keeps its own chunks.
  3. **spill** — received runs land in a :class:`SpillBuffer`; above the
     per-worker budget (``REPRO_SHUFFLE_BUDGET``) runs spill to disk as
     per-column ``.npy`` files and are read back memory-mapped, so the
     merge never needs the whole partition resident.
  4. **stream-merge** — :meth:`SpillBuffer.merge_sorted` k-way merges the
     sorted runs in bounded chunks; :func:`merge_join_sorted` merge-joins
     two such streams for ``dist_join``.

The task payloads (:func:`sort_task`, :func:`join_task`) generate their
input deterministically from ``(seed, part)`` — a SIGKILLed worker's retry
(same uid, new attempt, surviving workers) reproduces the identical global
result, which is what the recovery tests assert.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from time import perf_counter

import numpy as np

from repro_torch.obs.spans import current_recorder

_HASH_MULT = np.uint32(2654435761)

DEFAULT_BUDGET = 64 << 20   # 64 MiB per worker unless REPRO_SHUFFLE_BUDGET


def parse_budget(s, default: int = DEFAULT_BUDGET) -> int:
    """``REPRO_SHUFFLE_BUDGET`` parser: plain bytes or k/m/g suffix
    (``"32m"``, ``"256K"``, ``"1g"``, ``"1048576"``)."""
    if s is None or s == "":
        return default
    if isinstance(s, int):
        return s
    t = str(s).strip().lower().rstrip("b")
    scale = 1
    if t and t[-1] in "kmg":
        scale = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[t[-1]]
        t = t[:-1]
    return int(float(t) * scale)


def hash32(key: np.ndarray) -> np.ndarray:
    """Knuth multiplicative hash -> uint32; the numpy twin of
    ``ops_local.hash_key`` so both shuffle paths partition identically."""
    k = key.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = (k * _HASH_MULT) ^ (k >> np.uint32(16))
        return h * _HASH_MULT


# ---------------------------------------------------------------------------
# 1. local bucketing: the CUDA radix-partition packing stage
# ---------------------------------------------------------------------------
def radix_bucket(cols: dict, buckets: np.ndarray, n_buckets: int, *,
                 device=None, verify: bool = False):
    """Bucket-major local packing via the ``radix_partition`` kernel.

    ``cols`` is a dict name -> (n,)-leading np array, ``buckets`` the (n,)
    int32 destination of each row.  Returns ``(chunks, hist)``: ``chunks[j]``
    holds bucket j's rows (original order preserved — the kernel's ranks are
    stable) as contiguous host arrays ready for a peer frame, ``hist`` the
    rows-per-bucket histogram.

    The destinations are computed on ``device`` (the card unless the caller
    names another; a CPU device takes the kernel's plain version).
    ``verify=True`` cross-checks the kernel output bit-for-bit against the
    ``ref.py`` oracle and raises on any mismatch — the acceptance hook the
    shuffle tests flip on.
    """
    import torch

    from repro_torch.core.communicator import resolve_device
    from repro_torch.kernels.radix_partition.ops import radix_partition

    n = int(len(buckets))
    if n == 0:
        return ([{k: np.asarray(v)[:0] for k, v in cols.items()}
                 for _ in range(n_buckets)],
                np.zeros(n_buckets, np.int64))
    dev = resolve_device(device)
    b = torch.from_numpy(np.ascontiguousarray(buckets, np.int32)).to(dev)
    dest_t, hist_t = radix_partition(b, n_buckets)
    dest = dest_t.cpu().numpy()
    hist = hist_t.cpu().numpy().astype(np.int64)
    if verify:
        from repro_torch.kernels.radix_partition.ref import destinations_ref
        dref, href = destinations_ref(b, n_buckets)
        if not (np.array_equal(dest, dref.cpu().numpy())
                and np.array_equal(hist, href.cpu().numpy().astype(np.int64))):
            raise AssertionError(
                "radix_partition kernel output diverges from ref.py")
    perm = np.empty(n, np.int64)
    perm[dest] = np.arange(n)
    offs = np.concatenate([[0], np.cumsum(hist)])
    chunks = []
    major = {k: np.asarray(v)[perm] for k, v in cols.items()}
    for j in range(n_buckets):
        lo, hi = int(offs[j]), int(offs[j + 1])
        chunks.append({k: v[lo:hi] for k, v in major.items()})
    return chunks, hist


# ---------------------------------------------------------------------------
# 3. spill: bounded-memory run store
# ---------------------------------------------------------------------------
class SpillBuffer:
    """Received shuffle runs under a byte budget, spilled to disk beyond it.

    Each :meth:`add` stores one run SORTED by ``key``.  While the resident
    total stays under ``budget_bytes`` runs are kept in memory; a run that
    would cross the budget is written as per-column ``.npy`` files and read
    back memory-mapped, so :meth:`merge_sorted` touches only the pages each
    merge chunk needs.  ``spills`` counts spilled runs — the tasks add it to
    ``comm.spills`` so the evidence reaches the scheduler trace."""

    def __init__(self, budget_bytes: int, key: str, spill_dir=None):
        self.budget = int(budget_bytes)
        self.key = key
        self.runs: list[dict] = []
        self.spills = 0
        self.spill_bytes = 0     # bytes written to disk across spilled runs
        # (the telemetry counter a worker's heartbeat reports)
        self._mem = 0
        self._dir = spill_dir
        self._own_dir = spill_dir is None

    def _spill_path(self) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix="repro-shuffle-")
        return self._dir

    def add(self, run: dict):
        """Add one run (dict name -> (n,)-leading arrays, any order)."""
        k = np.asarray(run[self.key])
        if len(k) == 0:
            return
        order = np.argsort(k, kind="stable")
        srun = {name: np.ascontiguousarray(np.asarray(v)[order])
                for name, v in run.items()}
        nbytes = sum(v.nbytes for v in srun.values())
        if self._mem + nbytes > self.budget:
            # the thread-bound flight recorder (a no-op outside instrumented
            # worker parts) times the disk write — no parameter plumbing
            with current_recorder().span("spill_write"):
                d = self._spill_path()
                i = self.spills
                mapped = {}
                for name, v in srun.items():
                    path = os.path.join(d, f"run{i}_{name}.npy")
                    np.save(path, v)
                    mapped[name] = np.load(path, mmap_mode="r")
            self.runs.append(mapped)
            self.spills += 1
            self.spill_bytes += nbytes
        else:
            self.runs.append(srun)
            self._mem += nbytes

    def merge_sorted(self, chunk_rows: int = 65536):
        """Yield dict chunks in global key order (k-way merge of the sorted
        runs), never materializing more than ~``chunk_rows`` rows per run.

        Boundary rule: a chunk may emit only keys <= the smallest
        "last loaded key" among runs that still have UNLOADED rows — any
        unloaded row's key is >= its run's last loaded key, so nothing
        yielded later can sort before what was emitted."""
        runs = [r for r in self.runs if len(r[self.key])]
        if not runs:
            return
        totals = [len(r[self.key]) for r in runs]
        cursors = [0] * len(runs)
        bufs: list = [None] * len(runs)

        def load(i):
            lo = cursors[i]
            hi = min(lo + chunk_rows, totals[i])
            cursors[i] = hi
            return {k: np.asarray(v[lo:hi]) for k, v in runs[i].items()}

        rec = current_recorder()
        while True:
            t0 = perf_counter()
            for i in range(len(runs)):
                if (bufs[i] is None or len(bufs[i][self.key]) == 0) \
                        and cursors[i] < totals[i]:
                    bufs[i] = load(i)
            active = [i for i in range(len(runs))
                      if bufs[i] is not None and len(bufs[i][self.key])]
            if not active:
                return
            bounds = [bufs[i][self.key][-1] for i in active
                      if cursors[i] < totals[i]]
            pieces = []
            for i in active:
                bk = bufs[i][self.key]
                cut = len(bk) if not bounds else int(
                    np.searchsorted(bk, min(bounds), side="right"))
                if cut:
                    pieces.append({k: v[:cut] for k, v in bufs[i].items()})
                    bufs[i] = {k: v[cut:] for k, v in bufs[i].items()}
            # progress is guaranteed: the run attaining min(bounds) always
            # emits through its last loaded row
            out = {k: np.concatenate([p[k] for p in pieces])
                   for k in pieces[0]}
            order = np.argsort(out[self.key], kind="stable")
            chunk = {k: v[order] for k, v in out.items()}
            # explicit add (not the with-form): a context manager spanning
            # the yield would charge the CONSUMER's work to the merge span
            rec.add("merge", t0, perf_counter())
            yield chunk

    def close(self):
        self.runs = []
        if self._own_dir and self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None


# ---------------------------------------------------------------------------
# 4. stream merge-join of two sorted run streams
# ---------------------------------------------------------------------------
def _join_sorted(lc: dict, rc: dict, key: str) -> dict:
    """Inner join of two key-sorted chunks (duplicate keys -> cross
    product).  Column naming matches ``ops_local.join_inner``: the key is
    kept once, colliding value columns get l_/r_ prefixes."""
    lk, rk = lc[key], rc[key]
    lo = np.searchsorted(rk, lk, side="left")
    hi = np.searchsorted(rk, lk, side="right")
    counts = hi - lo
    total = int(counts.sum())
    li = np.repeat(np.arange(len(lk)), counts)
    ends = np.cumsum(counts)
    ri = (lo[li] + (np.arange(total) - (ends - counts)[li])) \
        if total else np.zeros(0, np.int64)
    out = {key: lk[li]}
    for name, v in lc.items():
        if name != key:
            out[f"l_{name}" if name in rc else name] = v[li]
    for name, v in rc.items():
        if name != key:
            out[f"r_{name}" if name in lc else name] = v[ri]
    return out


def merge_join_sorted(liter, riter, key: str):
    """Streaming inner join of two iterators of key-sorted chunks (e.g. two
    :meth:`SpillBuffer.merge_sorted` streams); yields joined chunks.

    Keys strictly below ``min(last loaded key of each unfinished side)``
    are complete on both sides and can be joined and discarded; an
    equal-key group straddling a chunk boundary stays in the carry buffer
    until the bound moves past it."""
    def pull(it):
        try:
            return next(it)
        except StopIteration:
            return None

    def cat(a, b):
        return {k: np.concatenate([a[k], b[k]]) for k in a}

    lbuf = rbuf = None
    ldone = rdone = False
    while True:
        if (lbuf is None or len(lbuf[key]) == 0) and not ldone:
            nxt = pull(liter)
            if nxt is None:
                ldone = True
            else:
                lbuf = nxt if lbuf is None or len(lbuf[key]) == 0 \
                    else cat(lbuf, nxt)
                continue
        if (rbuf is None or len(rbuf[key]) == 0) and not rdone:
            nxt = pull(riter)
            if nxt is None:
                rdone = True
            else:
                rbuf = nxt if rbuf is None or len(rbuf[key]) == 0 \
                    else cat(rbuf, nxt)
                continue
        lempty = lbuf is None or len(lbuf[key]) == 0
        rempty = rbuf is None or len(rbuf[key]) == 0
        if (lempty and ldone) or (rempty and rdone):
            return
        bounds = []
        if not ldone:
            bounds.append(lbuf[key][-1])
        if not rdone:
            bounds.append(rbuf[key][-1])
        if not bounds:
            chunk = _join_sorted(lbuf, rbuf, key)
            lbuf = {k: v[:0] for k, v in lbuf.items()}
            rbuf = {k: v[:0] for k, v in rbuf.items()}
            if len(chunk[key]):
                yield chunk
            continue
        bound = min(bounds)
        lcut = int(np.searchsorted(lbuf[key], bound, side="left"))
        rcut = int(np.searchsorted(rbuf[key], bound, side="left"))
        if lcut == 0 and rcut == 0:
            # every buffered key is >= bound: the side whose last key IS the
            # bound may still have unloaded duplicates — extend it
            if not ldone and (rdone or lbuf[key][-1] <= rbuf[key][-1]):
                nxt = pull(liter)
                if nxt is None:
                    ldone = True
                else:
                    lbuf = cat(lbuf, nxt)
            else:
                nxt = pull(riter)
                if nxt is None:
                    rdone = True
                else:
                    rbuf = cat(rbuf, nxt)
            continue
        chunk = _join_sorted({k: v[:lcut] for k, v in lbuf.items()},
                             {k: v[:rcut] for k, v in rbuf.items()}, key)
        lbuf = {k: v[lcut:] for k, v in lbuf.items()}
        rbuf = {k: v[rcut:] for k, v in rbuf.items()}
        if len(chunk[key]):
            yield chunk


# ---------------------------------------------------------------------------
# task payloads (deterministic per (seed, part))
# ---------------------------------------------------------------------------
def _gen_part(spec: dict, part: int, side: int = 0) -> dict:
    """Deterministic per-(seed, part, side) row block: an int32 ``key``
    column plus ``payload_width`` int64 value columns (``v0..`` on side 0,
    ``w0..`` on side 1 so join outputs need no renames)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(spec.get("seed", 0)), part, side]))
    n = int(spec["rows_per_part"])
    key_range = int(spec.get("key_range", max(4 * n, 16)))
    cols = {"key": rng.integers(0, key_range, n, dtype=np.int32)}
    prefix = "v" if side == 0 else "w"
    for j in range(int(spec.get("payload_width", 1))):
        cols[f"{prefix}{j}"] = rng.integers(0, 1 << 30, n, dtype=np.int64)
    return cols


def _budget(spec: dict) -> int:
    return spec["budget"] if spec.get("budget") is not None else \
        parse_budget(os.environ.get("REPRO_SHUFFLE_BUDGET"))


def _device(comm, spec: dict):
    """Where a part computes its bucketing: ``spec["device"]`` if given,
    else the device of the comm's first rank, else the card."""
    if spec.get("device") is not None:
        return spec["device"]
    if hasattr(comm, "device_of"):
        return comm.device_of(0)
    return None


def _exchange(comm, chunks: list) -> list:
    """Ship per-destination chunks through the comm; outside a
    multi-process part there is nothing to exchange and the local chunks
    come straight back."""
    if hasattr(comm, "all_to_all_arrays"):
        return comm.all_to_all_arrays(chunks)
    return chunks


def _u64sum(a: np.ndarray) -> int:
    return int(np.bitwise_and(
        np.add.reduce(a.astype(np.uint64), dtype=np.uint64),
        np.uint64(0xFFFFFFFFFFFFFFFF)))


def sort_task(comm, spec: dict) -> dict:
    """Distributed sample sort, out-of-core: deterministic local rows ->
    splitters from an allgathered sample -> radix_bucket -> raw-frame
    exchange -> SpillBuffer -> streamed merge.  Returns a global summary
    (row count, uint64 key checksum, sortedness incl. part boundaries,
    spill count) identical with or without spilling; ``collect=True``
    additionally returns the fully sorted rows (small sizes / tests)."""
    part = getattr(comm, "part", 0)
    n_parts = getattr(comm, "n_parts", 1)
    cols = _gen_part(spec, part)
    keys = cols["key"]
    # splitters: even quantiles of the allgathered per-part sample
    oversample = 32
    sk = np.sort(keys)
    q = (np.arange(n_parts * oversample) + 0.5) / (n_parts * oversample)
    samples = sk[np.clip((q * len(sk)).astype(np.int64), 0,
                         max(len(sk) - 1, 0))] if len(sk) else sk
    if n_parts > 1:
        samples = np.sort(np.concatenate(comm.allgather(samples)))
    splitters = samples[(np.arange(1, n_parts) * len(samples)) // n_parts] \
        if len(samples) else np.zeros(n_parts - 1, keys.dtype)
    target = np.searchsorted(splitters, keys, side="right").astype(np.int32)
    chunks, _ = radix_bucket(cols, target, n_parts,
                             device=_device(comm, spec),
                             verify=bool(spec.get("verify_kernel", False)))
    received = _exchange(comm, chunks)
    buf = SpillBuffer(_budget(spec), "key")
    try:
        for run in received:
            buf.add(run)
        if spec.get("stall_s"):     # kill-mid-shuffle test hook: spilled
            time.sleep(float(spec["stall_s"]))  # buckets exist right now
        total, ksum, first, last = 0, 0, None, None
        ordered = True
        prev_last = None
        collected = []
        for chunk in buf.merge_sorted(int(spec.get("chunk_rows", 65536))):
            k = chunk["key"]
            ordered = ordered and bool(np.all(k[1:] >= k[:-1])) and \
                (prev_last is None or k[0] >= prev_last)
            prev_last = k[-1]
            total += len(k)
            ksum = (ksum + _u64sum(k)) & 0xFFFFFFFFFFFFFFFF
            first = int(k[0]) if first is None else first
            last = int(k[-1])
            if spec.get("collect"):
                collected.append(chunk)
        if hasattr(comm, "spills"):
            comm.spills += buf.spills
        if hasattr(comm, "metrics"):
            comm.metrics.inc("spill_bytes", buf.spill_bytes)
        summary = {"part": part, "n": total, "key_sum": ksum, "min": first,
                   "max": last, "sorted": ordered, "spills": buf.spills}
        if spec.get("collect"):
            names = list(cols)
            summary["rows"] = {
                k: (np.concatenate([c[k] for c in collected])
                    if collected else np.zeros(0, cols[k].dtype))
                for k in names}
    finally:
        buf.close()
    parts = comm.allgather(summary) if n_parts > 1 else [summary]
    parts.sort(key=lambda s: s["part"])
    edges_ok = all(
        a["max"] is None or b["min"] is None or a["max"] <= b["min"]
        for a, b in zip(parts[:-1], parts[1:], strict=True))
    out = {"n": sum(s["n"] for s in parts),
           "key_sum": sum(s["key_sum"] for s in parts) & 0xFFFFFFFFFFFFFFFF,
           "sorted": all(s["sorted"] for s in parts) and edges_ok,
           "spills": sum(s["spills"] for s in parts)}
    if spec.get("collect"):
        out["rows"] = {k: np.concatenate([s["rows"][k] for s in parts])
                       for k in parts[0]["rows"]}
    return out


def join_task(comm, spec: dict) -> dict:
    """Distributed hash join, out-of-core: both sides hash-partitioned with
    :func:`hash32` (the ``ops_local.hash_key`` twin), radix-bucketed,
    exchanged as raw frames, spilled under the budget, and merge-joined
    from the two sorted streams.  Summary checksums (row count, uint64 sums
    of key and both value columns) are identical with or without spill."""
    part = getattr(comm, "part", 0)
    n_parts = getattr(comm, "n_parts", 1)
    left = _gen_part(spec, part, side=0)
    rspec = dict(spec)
    rspec["rows_per_part"] = int(
        spec.get("right_rows_per_part", spec["rows_per_part"]))
    right = _gen_part(rspec, part, side=1)
    budget = _budget(spec)
    lbuf = SpillBuffer(budget, "key")
    rbuf = SpillBuffer(budget, "key")
    try:
        for table, buf in ((left, lbuf), (right, rbuf)):
            tgt = (hash32(table["key"]) % np.uint32(n_parts)).astype(np.int32)
            chunks, _ = radix_bucket(table, tgt, n_parts,
                                     device=_device(comm, spec),
                                     verify=bool(spec.get("verify_kernel",
                                                          False)))
            for run in _exchange(comm, chunks):
                buf.add(run)
        if spec.get("stall_s"):
            time.sleep(float(spec["stall_s"]))
        chunk_rows = int(spec.get("chunk_rows", 65536))
        total, ksum, vsum, wsum = 0, 0, 0, 0
        collected = []
        for chunk in merge_join_sorted(lbuf.merge_sorted(chunk_rows),
                                       rbuf.merge_sorted(chunk_rows), "key"):
            total += len(chunk["key"])
            ksum = (ksum + _u64sum(chunk["key"])) & 0xFFFFFFFFFFFFFFFF
            vsum = (vsum + _u64sum(chunk["v0"])) & 0xFFFFFFFFFFFFFFFF
            wsum = (wsum + _u64sum(chunk["w0"])) & 0xFFFFFFFFFFFFFFFF
            if spec.get("collect"):
                collected.append(chunk)
        if hasattr(comm, "spills"):
            comm.spills += lbuf.spills + rbuf.spills
        if hasattr(comm, "metrics"):
            comm.metrics.inc("spill_bytes",
                             lbuf.spill_bytes + rbuf.spill_bytes)
        summary = {"part": part, "n": total, "key_sum": ksum,
                   "v_sum": vsum, "w_sum": wsum,
                   "spills": lbuf.spills + rbuf.spills}
        if spec.get("collect"):
            summary["rows"] = {
                k: (np.concatenate([c[k] for c in collected])
                    if collected else np.zeros(0, np.int64))
                for k in (collected[0] if collected
                          else {"key": None, "v0": None, "w0": None})}
    finally:
        lbuf.close()
        rbuf.close()
    parts = comm.allgather(summary) if n_parts > 1 else [summary]
    parts.sort(key=lambda s: s["part"])
    out = {"n": sum(s["n"] for s in parts),
           "key_sum": sum(s["key_sum"] for s in parts) & 0xFFFFFFFFFFFFFFFF,
           "v_sum": sum(s["v_sum"] for s in parts) & 0xFFFFFFFFFFFFFFFF,
           "w_sum": sum(s["w_sum"] for s in parts) & 0xFFFFFFFFFFFFFFFF,
           "spills": sum(s["spills"] for s in parts)}
    if spec.get("collect"):
        out["rows"] = {k: np.concatenate([s["rows"][k] for s in parts])
                       for k in parts[0]["rows"]}
    return out
