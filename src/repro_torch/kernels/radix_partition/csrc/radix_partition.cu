// Stable radix partition for Hopper (sm_90a): bucket-major destinations plus
// the bucket histogram, in one histogram pass and one ranking pass.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/radix_partition/radix_partition.py::radix_partition_kernel
// (with its `_kernel`), whose sequential grid carries per-bucket cursors in
// VMEM scratch from one block to the next.  Blocks on Hopper run in no fixed
// order, so the cursors become a scan over tiles of TILE rows, two launches a
// call whatever B:
//
//   B <= SMALL_BUCKETS (every bucket count the dataframe layer uses): reduce,
//   then scan.  A grid of G CTAs, as many as the card holds at once, gives
//   CTA c the tiles [c * n_tiles / G, (c + 1) * n_tiles / G).
//     1. radix_hist_small - CTA c counts its chunk's rows per bucket and
//        writes totals[b][c].  It walks its chunk from the last tile to the
//        first, so the tiles pass 2 reads first are the ones still in L2.
//     2. radix_rank_small - CTA c sums totals[b][c'] over c' < c (and over
//        all c' for the histogram and the bucket offsets), then ranks its
//        tiles in order, carrying each bucket's next slot from tile to tile.
//        No tile waits on another CTA.  The next tile's 16-byte cp.async
//        copies run while the CTA ranks the current one.
//   Ranking a tile: each thread owns ITEMS consecutive rows and a column of
//   B counters in shared memory ([bucket][thread]: no two threads on a word,
//   no bank conflicts) and counts its rows there; warp w scans buckets w,
//   w + WARPS, ... over the threads, which gives each thread the earlier
//   rows of each bucket in the tile (CUB's BlockRadixRank, one digit).  No
//   atomics, no warp votes, four barriers a tile.  Tiles pass through a
//   swizzled stage in shared memory, so global loads and stores are
//   warp-contiguous 16-byte words while a thread ranks consecutive rows.
//
//   Larger B (up to MAX_BUCKETS): Onesweep's chained scan (Adinets and
//   Merrill 2022, cut down to one digit).  radix_hist_large counts into one
//   shared counter a bucket and adds them to the histogram with one atomicAdd
//   per (CTA, bucket).  radix_rank_large takes its tile from an atomic ticket,
//   stages it in shared memory, ranks each warp's rows 32 at a time with peer
//   masks built from one __ballot_sync per bit of the bucket id against
//   per-warp counters, and finds the earlier tiles' counts by a decoupled
//   look-back: one thread a bucket publishes the tile's count with a flag in
//   one 64-bit word and sums the earlier tiles' words back to an inclusive
//   prefix.  Its scratch is zeroed by one memset on the stream.
//
// Bound: the function must read `buckets` and write `dest`, 8 bytes a row,
// with almost no arithmetic, so memory bandwidth bounds it.  This design
// reads `buckets` twice (12 bytes a row).  What the previous design
// (count / scan-tiles / scan-hist / rank) lost, and what this one does:
//   - 4 dependent launches, two of them B CTAs and one CTA: now 2 launches,
//     both as wide as the card;
//   - scalar 4-byte loads and stores: now 16-byte ones (a scalar head and
//     tail only in the tiles at the array's ends);
//   - __match_any_sync on every row, twice: none;
//   - three barriers per 256 rows of a tile: now four a tile for small B,
//     and shared memory sized by B, not MAX_BUCKETS.
// A decoupled look-back for small B was measured and dropped: CTAs that
// start together publish together, and the look-back cost more than half of
// the ranking pass (PERF.md).
//
// A 1-D view may start at any 4-byte address (`b[1:]`).  The kernels index
// rows from the 16-byte boundary at or below `buckets`: virtual row
// v = row + mis, mis = (buckets % 16) / 4, so a group of 4 virtual rows is one
// aligned 16-byte word.  A group that lies wholly inside [0, n) is loaded and
// stored as one vector; one that does not is read and written row by row,
// and rows outside [0, n) are never touched.  `dest` must lie at the same
// address modulo 16 as `buckets` (the wrapper allocates it so).
//
// Rows whose bucket lies outside [0, B) are neither counted nor placed: their
// dest is -1.  Every launch goes on the caller's stream; the entry point
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

// TILE (rows a CTA ranks), THREADS (a CTA), SMALL_BUCKETS (the largest B
// counted in per-thread columns) and MAX_BUCKETS (the largest B) come from
// the wrapper, ops.py, as -D flags: it sizes the scratch by TILE and rejects
// B above MAX_BUCKETS.
#if !defined(TILE) || !defined(THREADS) || !defined(SMALL_BUCKETS) || \
    !defined(MAX_BUCKETS)
#error "build with -DTILE -DTHREADS -DSMALL_BUCKETS -DMAX_BUCKETS (ops.py)"
#endif
#define WARPS (THREADS / 32)
#define ITEMS (TILE / THREADS)          // rows a thread owns in a tile
#define GROUPS (ITEMS / 4)              // its 16-byte groups
#define WARP_ROWS (TILE / WARPS)        // rows a warp owns (large B)
#define PER_THREAD ((MAX_BUCKETS + THREADS - 1) / THREADS)
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
static_assert(TILE % THREADS == 0 && ITEMS % 4 == 0, "16-byte groups");
static_assert(ITEMS < 256, "a row's rank in its thread fits 8 bits");
static_assert(WARP_ROWS % 32 == 0, "whole warp steps");
static_assert(SMALL_BUCKETS < 256 && SMALL_BUCKETS <= THREADS,
              "a bucket id fits 8 bits; a thread for each bucket's offset");
static_assert(GROUPS == 1 || GROUPS == 2 || GROUPS == 4 || GROUPS == 8,
              "the staging swizzle");

typedef unsigned long long u64;
#define FLAG_AGGREGATE (1ull << 32)     // the tile's own count
#define FLAG_PREFIX (2ull << 32)        // this and every earlier tile's

// The rows as the kernels see them: row r sits at virtual row r + mis.
struct Rows {
  const int32_t* buckets;
  int32_t* dest;
  long long n;
  int mis;
};

static __device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return smem_raw;
}

static __device__ __forceinline__ bool in_range(int b, int B) {
  return (unsigned)b < (unsigned)B;
}

// Whether every row of the tile lies inside [0, n).
static __device__ __forceinline__ bool tile_is_full(const Rows& in,
                                                    long long tile) {
  const long long r0 = tile * TILE - in.mis;
  return r0 >= 0 && r0 + TILE <= in.n;
}

// Groups g0 + j * step (j < GROUPS) into v[4j .. 4j + 3].  In a full tile
// every load is one 16-byte vector, all issued before any is used; at the
// array's ends rows outside [0, n) read as -1 (not counted).
static __device__ __forceinline__ void load_groups(const Rows& in, bool full,
                                                   long long g0, int step,
                                                   int v[ITEMS]) {
  const int4* base = reinterpret_cast<const int4*>(in.buckets - in.mis);
  if (full) {
    int4 x[GROUPS];
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) x[j] = base[g0 + (long long)j * step];
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      v[4 * j] = x[j].x; v[4 * j + 1] = x[j].y;
      v[4 * j + 2] = x[j].z; v[4 * j + 3] = x[j].w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const long long r0 = 4 * (g0 + (long long)j * step) - in.mis;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = r0 + e;
      v[4 * j + e] = (r >= 0 && r < in.n) ? in.buckets[r] : -1;
    }
  }
}

static __device__ __forceinline__ void store_groups(const Rows& in, bool full,
                                                    long long g0, int step,
                                                    const int d[ITEMS]) {
  int4* base = reinterpret_cast<int4*>(in.dest - in.mis);
  if (full) {
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
      base[g0 + (long long)j * step] =
          make_int4(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const long long r0 = 4 * (g0 + (long long)j * step) - in.mis;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = r0 + e;
      if (r >= 0 && r < in.n) in.dest[r] = d[4 * j + e];
    }
  }
}

// A tile staged in shared memory as TILE / 4 16-byte groups.  Group L sits
// at L ^ ((L / 8) % GROUPS): eight threads reading 8 consecutive groups
// (warp-contiguous, as global memory is read and written) and eight reading
// a group each from 8 consecutive threads' rows (thread t owns groups
// t * GROUPS ..) both meet 8 different bank quads.
static __device__ __forceinline__ int swz(int L) {
  return L ^ ((L >> 3) & (GROUPS - 1));
}

static __device__ __forceinline__ void cp_async16(int4* smem,
                                                  const int4* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying tile `tile` into `stage`: in a full tile each thread's
// groups go by cp.async and land while the CTA works on the tile before;
// at the array's ends the rows are read here, those outside [0, n) as -1.
static __device__ __forceinline__ void fetch_tile(const Rows& in,
                                                  long long tile,
                                                  int4* stage) {
  const long long g0 = tile * (TILE / 4) + threadIdx.x;
  if (tile_is_full(in, tile)) {
    const int4* base = reinterpret_cast<const int4*>(in.buckets - in.mis);
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
      cp_async16(&stage[swz(j * THREADS + threadIdx.x)],
                 base + g0 + (long long)j * THREADS);
    return;
  }
  int v[ITEMS];
  load_groups(in, false, g0, THREADS, v);
#pragma unroll
  for (int j = 0; j < GROUPS; ++j)
    stage[swz(j * THREADS + threadIdx.x)] =
        make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

// Publish this tile's own count `agg` of bucket b for the tiles after it.
static __device__ __forceinline__ void publish_aggregate(u64* status, int tile,
                                                         int B, int b,
                                                         unsigned agg) {
  if (tile > 0)
    *((volatile u64*)status + (long long)tile * B + b) = FLAG_AGGREGATE | agg;
}

// Look back over the earlier tiles' words of bucket b until an inclusive
// prefix, publish this tile's inclusive prefix (its own count is `agg`,
// published before by publish_aggregate), and return the count of bucket b
// in the earlier tiles.  Tiles are handed out in ticket order, so every
// earlier tile's CTA is running or done and publishes its count without
// waiting on this one.
static __device__ unsigned look_back(u64* status, int tile, int B, int b,
                                     unsigned agg) {
  volatile u64* words = status;
  volatile u64* mine = words + (long long)tile * B + b;
  if (tile == 0) {
    *mine = FLAG_PREFIX | agg;
    return 0;
  }
  unsigned excl = 0;
  for (long long t = tile - 1;; --t) {
    u64 s;
    do {
      s = words[t * B + b];
    } while ((s >> 32) == 0);
    excl += (unsigned)s;
    if ((s >> 32) == 2) break;
  }
  *mine = FLAG_PREFIX | (excl + agg);
  return excl;
}

// ---------------------------------------------------------------------------
// Pass 1: the histogram.
// ---------------------------------------------------------------------------
// CTA c of a grid of G owns the tiles [chunk(c), chunk(c + 1)).
static __device__ __forceinline__ long long chunk(long long c, long long G,
                                                  long long n_tiles) {
  return c * n_tiles / G;
}

// B <= SMALL_BUCKETS: each CTA counts its chunk's rows, from its last tile
// to its first, in per-thread columns of counters (row B for rows that are
// not counted), and writes the chunk's count of bucket b to totals[b][c].
__global__ void __launch_bounds__(THREADS)
radix_hist_small(Rows in, int B, long long n_tiles, int32_t* totals) {
  int* s_cnt = reinterpret_cast<int*>(dyn_smem());   // [B + 1][THREADS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long first = chunk(blockIdx.x, gridDim.x, n_tiles);
  for (int b = 0; b <= B; ++b) s_cnt[b * THREADS + tid] = 0;
  for (long long tile = chunk(blockIdx.x + 1, gridDim.x, n_tiles) - 1;
       tile >= first; --tile) {
    int v[ITEMS];
    load_groups(in, tile_is_full(in, tile), tile * (TILE / 4) + tid, THREADS,
                v);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      ++s_cnt[(in_range(v[i], B) ? v[i] : B) * THREADS + tid];
  }
  __syncthreads();
  for (int b = warp; b < B; b += WARPS) {
    int x = 0;
    for (int t = lane; t < THREADS; t += 32) x += s_cnt[b * THREADS + t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) totals[(long long)b * gridDim.x + blockIdx.x] = x;
  }
}

// Larger B: one counter per bucket in shared memory.
__global__ void __launch_bounds__(THREADS)
radix_hist_large(Rows in, int B, long long n_tiles, int32_t* hist_acc) {
  int* s_hist = reinterpret_cast<int*>(dyn_smem());  // [B]
  for (int b = threadIdx.x; b < B; b += THREADS) s_hist[b] = 0;
  __syncthreads();
  for (long long k = blockIdx.x; k < n_tiles; k += gridDim.x) {
    const long long tile = n_tiles - 1 - k;     // the last tiles first
    int v[ITEMS];
    load_groups(in, tile_is_full(in, tile), tile * (TILE / 4) + threadIdx.x,
                THREADS, v);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (in_range(v[i], B)) atomicAdd(&s_hist[v[i]], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += THREADS)
    if (s_hist[b]) atomicAdd(&hist_acc[b], s_hist[b]);
}

// ---------------------------------------------------------------------------
// Pass 2: stable ranks.
// ---------------------------------------------------------------------------
// B <= SMALL_BUCKETS, on the same grid as radix_hist_small: CTA c ranks its
// chunk's tiles in order.  Bucket b's rows before the chunk are the offset
// of b plus totals[b][c'] summed over c' < c, so no tile waits on another;
// the next tile's cp.async copies run while the CTA ranks the current one.
__global__ void __launch_bounds__(THREADS)
radix_rank_small(Rows in, int B, long long n_tiles, const int32_t* totals,
                 int32_t* hist) {
  int4* s_stage = reinterpret_cast<int4*>(dyn_smem());     // [2][TILE / 4]
  int* s_cnt = reinterpret_cast<int*>(s_stage + TILE / 2);  // [B + 1][THREADS]
  int* s_base = s_cnt + (B + 1) * THREADS;   // [B]: the tile's first slots
  int* s_run = s_base + B;                   // [B]: the next tile's
  int* s_hist = s_run + B;                   // [B]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, G = gridDim.x;
  const long long first = chunk(c, G, n_tiles), end = chunk(c + 1, G, n_tiles);
  if (first < end) fetch_tile(in, first, s_stage);
  for (int b = warp; b < B; b += WARPS) {
    int all = 0, before = 0;
    for (int k = lane; k < G; k += 32) {
      const int x = totals[(long long)b * G + k];
      all += x;
      before += k < c ? x : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      all += __shfl_xor_sync(0xffffffffu, all, o);
      before += __shfl_xor_sync(0xffffffffu, before, o);
    }
    if (lane == 0) {
      s_hist[b] = all;
      s_run[b] = before;
    }
  }
  __syncthreads();
  if (tid < B) {
    int offset = 0;
    for (int b = 0; b < tid; ++b) offset += s_hist[b];
    s_run[tid] += offset;
    if (c == 0) hist[tid] = s_hist[tid];
  }
  for (long long tile = first; tile < end; ++tile) {
    int4* cur = s_stage + ((tile - first) & 1) * (TILE / 4);
    for (int b = 0; b <= B; ++b) s_cnt[b * THREADS + tid] = 0;
    cp_async_wait_all();
    __syncthreads();
    if (tile + 1 < end)
      fetch_tile(in, tile + 1, s_stage + ((tile + 1 - first) & 1) * (TILE / 4));
    // v[i]: the row's bucket and its rank among this thread's rows of that
    // bucket (bucket | rank << 8), or -1 for a row that is not placed
    int v[ITEMS];
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      const int4 x = cur[swz(tid * GROUPS + j)];
      v[4 * j] = x.x; v[4 * j + 1] = x.y; v[4 * j + 2] = x.z;
      v[4 * j + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const bool ok = in_range(v[i], B);
      int* cell = &s_cnt[(ok ? v[i] : B) * THREADS + tid];
      const int r = *cell;
      *cell = r + 1;
      v[i] = ok ? (v[i] | r << 8) : -1;
    }
    __syncthreads();
    // warp w scans the counters of buckets w, w + WARPS, ... over the
    // threads (exclusive, in thread order) and moves the buckets' next slots
    // past this tile
    for (int b = warp; b < B; b += WARPS) {
      int carry = 0;
      for (int t = lane; t < THREADS; t += 32) {
        const int n_t = s_cnt[b * THREADS + t];
        int x = n_t;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        s_cnt[b * THREADS + t] = carry + x - n_t;
        carry += __shfl_sync(0xffffffffu, x, 31);
      }
      if (lane == 0) {
        s_base[b] = s_run[b];
        s_run[b] += carry;
      }
    }
    __syncthreads();
    // the destinations go back into the stage (this thread's groups), then
    // out warp-contiguously
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      int d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a row that is not placed reads bucket 0's words and drops them
        const int y = v[4 * j + e], x = y < 0 ? 0 : y, b = x & 0xff;
        const int r = s_base[b] + s_cnt[b * THREADS + tid] + (x >> 8);
        d[e] = y < 0 ? -1 : r;
      }
      cur[swz(tid * GROUPS + j)] = make_int4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();
    int d[ITEMS];
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      const int4 x = cur[swz(j * THREADS + tid)];
      d[4 * j] = x.x; d[4 * j + 1] = x.y; d[4 * j + 2] = x.z;
      d[4 * j + 3] = x.w;
    }
    store_groups(in, tile_is_full(in, tile), tile * (TILE / 4) + tid, THREADS,
                 d);
  }
}

// Lanes of the warp whose key equals this lane's (keys < 2^bits).
static __device__ __forceinline__ unsigned peers_of(unsigned key, int bits) {
  unsigned m = 0xffffffffu;
  for (int i = 0; i < bits; ++i) {
    const unsigned bit = (key >> i) & 1u;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    m &= bit ? set : ~set;
  }
  return m;
}

__global__ void __launch_bounds__(THREADS)
radix_rank_large(Rows in, int B, int key_bits, u64* status,
                 const int32_t* hist_acc, int32_t* hist, unsigned* ticket) {
  int* s_rows = reinterpret_cast<int*>(dyn_smem());   // [TILE]
  int* s_cnt = s_rows + TILE;                         // [WARPS][B]
  int* s_off = s_cnt + WARPS * B;                     // [B]
  int* s_sums = s_off + B;                            // [WARPS]
  int* s_tile = s_sums + WARPS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) *s_tile = (int)atomicAdd(ticket, 1u);
  for (int i = tid; i < WARPS * B; i += THREADS) s_cnt[i] = 0;
  // bucket offsets: thread t scans buckets [t * PER_THREAD, +PER_THREAD)
  int h[PER_THREAD], sum = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int b = tid * PER_THREAD + k;
    h[k] = b < B ? hist_acc[b] : 0;
    sum += h[k];
  }
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_sums[warp] = x;
  __syncthreads();
  int run = x - sum;
  for (int w = 0; w < warp; ++w) run += s_sums[w];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int b = tid * PER_THREAD + k;
    if (b < B) s_off[b] = run;
    run += h[k];
  }
  const int tile = *s_tile;
  const bool full = tile_is_full(in, tile);
  const long long g0 = (long long)tile * (TILE / 4) + tid;
  {
    int v[ITEMS];
    load_groups(in, full, g0, THREADS, v);
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
      reinterpret_cast<int4*>(s_rows)[j * THREADS + tid] =
          make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
  __syncthreads();
  int* rows = s_rows + warp * WARP_ROWS;
  int* cnt = s_cnt + warp * B;
  const unsigned below_mask = (1u << lane) - 1u;
  for (int c = 0; c < WARP_ROWS; c += 32) {
    const int b = rows[c + lane];
    const bool ok = in_range(b, B);
    const unsigned peers = peers_of(ok ? (unsigned)b : (unsigned)B, key_bits);
    if (ok && lane == __ffs(peers) - 1) cnt[b] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // per bucket: the warps' exclusive counts, the tile's count, the look-back
  unsigned agg[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int b = tid + k * THREADS;
    agg[k] = 0;
    if (b < B) {
      for (int w = 0; w < WARPS; ++w) {
        const int n_w = s_cnt[w * B + b];
        s_cnt[w * B + b] = (int)agg[k];
        agg[k] += n_w;
      }
      publish_aggregate(status, tile, B, b, agg[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int b = tid + k * THREADS;
    if (b < B) {
      const int base = s_off[b] + (int)look_back(status, tile, B, b, agg[k]);
      for (int w = 0; w < WARPS; ++w) s_cnt[w * B + b] += base;
      if (tile == 0) hist[b] = hist_acc[b];
    }
  }
  __syncthreads();
  for (int c = 0; c < WARP_ROWS; c += 32) {
    const int b = rows[c + lane];
    const bool ok = in_range(b, B);
    const unsigned peers = peers_of(ok ? (unsigned)b : (unsigned)B, key_bits);
    const bool leader = lane == __ffs(peers) - 1;
    const int d = ok ? cnt[b] + __popc(peers & below_mask) : -1;
    __syncwarp();
    if (ok && leader) cnt[b] += __popc(peers);
    rows[c + lane] = d;
    __syncwarp();
  }
  __syncthreads();
  int d[ITEMS];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int4 d4 = reinterpret_cast<const int4*>(s_rows)[j * THREADS + tid];
    d[4 * j] = d4.x; d[4 * j + 1] = d4.y; d[4 * j + 2] = d4.z;
    d[4 * j + 3] = d4.w;
  }
  store_groups(in, full, g0, THREADS, d);
}

// ---------------------------------------------------------------------------
// Entry point.
// ---------------------------------------------------------------------------
// A persistent grid: as many CTAs as fit on the card at once (at the
// kernel's largest shared memory, which is allowed here past the default 48
// KB), at most one a tile.  Found once per device and kernel (`slot`): the
// occupancy query takes microseconds of the caller's thread.
template <typename K>
static unsigned persistent_grid(int slot, K kernel, size_t largest_smem,
                                long long n_tiles) {
  static int cached[2][64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  int& grid = cached[slot][dev];
  if (!grid) {
    if (largest_smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)largest_smem);
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                  largest_smem);
    grid = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  return (unsigned)(n_tiles < grid ? n_tiles : grid);
}

// radix_rank_small's shared memory: two stages, the counters, and three
// words a bucket.
static size_t rank_small_smem(int B) {
  return (2 * (size_t)TILE + (size_t)(B + 1) * THREADS + 3 * B) * sizeof(int);
}

// buckets, dest: (n,) int32 at the same address modulo 16; hist: (B,) int32;
// scratch: 8-byte aligned, any contents, at least 2 * B * n_tiles + B + 1
// int32 words with n_tiles = ceil((n + 3) / TILE).  B <= SMALL_BUCKETS uses
// its first B * G words for the chunks' counts (G CTAs, G <= n_tiles);
// larger B zeroes it here on the stream and keeps the look-back words, the
// histogram's sums and the ticket there.
extern "C" int radix_partition_launch(const int32_t* buckets, int32_t* dest,
                                      int32_t* hist, int32_t* scratch, int n,
                                      int B, cudaStream_t stream) {
  if (n <= 0 || B < 1 || B > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)buckets % 4 || (uintptr_t)scratch % 8 ||
      ((uintptr_t)dest - (uintptr_t)buckets) % 16)
    return (int)cudaErrorMisalignedAddress;
  Rows in;
  in.buckets = buckets;
  in.dest = dest;
  in.n = n;
  in.mis = (int)(((uintptr_t)buckets % 16) / 4);
  const long long n_tiles = (n + in.mis + (long long)TILE - 1) / TILE;
  if (B <= SMALL_BUCKETS) {
    const unsigned G = persistent_grid(
        0, radix_rank_small, rank_small_smem(SMALL_BUCKETS), n_tiles);
    radix_hist_small<<<G, THREADS, (B + 1) * THREADS * sizeof(int),
                       stream>>>(in, B, n_tiles, scratch);
    radix_rank_small<<<G, THREADS, rank_small_smem(B), stream>>>(
        in, B, n_tiles, scratch, hist);
  } else {
    u64* status = reinterpret_cast<u64*>(scratch);
    int32_t* hist_acc = scratch + 2 * n_tiles * B;
    unsigned* ticket = reinterpret_cast<unsigned*>(hist_acc + B);
    cudaMemsetAsync(scratch, 0, (size_t)(2 * n_tiles * B + B + 1) * 4,
                    stream);
    const unsigned grid = persistent_grid(1, radix_hist_large,
                                          MAX_BUCKETS * sizeof(int), n_tiles);
    radix_hist_large<<<grid, THREADS, B * sizeof(int), stream>>>(
        in, B, n_tiles, hist_acc);
    const size_t rank_smem =
        (size_t)(TILE + WARPS * B + B + WARPS + 1) * sizeof(int);
    cudaFuncSetAttribute(radix_rank_large,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)rank_smem);
    const int key_bits = 32 - __builtin_clz((unsigned)B);   // ids 0..B
    radix_rank_large<<<(unsigned)n_tiles, THREADS, rank_smem, stream>>>(
        in, B, key_bits, status, hist_acc, hist, ticket);
  }
  return (int)cudaGetLastError();
}
