// Stable radix partition for Hopper (sm_90a): bucket-major destinations plus
// the bucket histogram.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/radix_partition/radix_partition.py::radix_partition_kernel
// (with its `_kernel`), whose sequential grid carries per-bucket cursors in
// VMEM scratch from one block to the next.  Blocks on Hopper run in no order,
// so the cursors become an explicit count / scan / rank split:
//
//   1. count  - one CTA per tile of TILE rows writes its per-bucket counts to
//               counts[bucket * n_tiles + tile] (shared-memory counters,
//               warp-aggregated with __match_any_sync; atomics only count).
//   2. scan   - one CTA per bucket scans that bucket's row of counts
//               (exclusive, in tile order) and writes hist[bucket]; one more
//               CTA scans hist into the bucket offsets.  Bucket-major order
//               means base(bucket, tile) = offset[bucket] + scanned count.
//   3. rank   - each CTA re-reads its tile in row order, one warp-sized chunk
//               per warp and the warps in row order, and writes
//               dest = base + stable in-tile rank.  A row's rank is the count
//               of equal-bucket lanes below it (__match_any_sync + __popc)
//               plus the counts of the earlier warps of the chunk plus the
//               running cursor of the tile; it never depends on atomic order.
//
// Bound: the function must read `buckets` and write `dest`, 8 bytes a row; it
// does almost no arithmetic, so memory bandwidth bounds it.  This design reads
// `buckets` twice (12 bytes a row); the count and scan arrays are B * n/TILE
// ints, small beside the rows for the bucket counts the shuffles use.
//
// Rows whose bucket lies outside [0, B) are neither counted nor placed: their
// dest is -1.  Every launch goes on the caller's stream; the entry point
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

// TILE (rows per CTA) and MAX_BUCKETS (shared-memory counters per CTA) come
// from the wrapper, ops.py, as -D flags: it sizes the counts scratch by TILE
// and rejects bucket counts above MAX_BUCKETS.
#if !defined(TILE) || !defined(MAX_BUCKETS)
#error "build with -DTILE=... -DMAX_BUCKETS=... (kernels/radix_partition/ops.py)"
#endif
#define RANK_THREADS 256
#define RANK_WARPS (RANK_THREADS / 32)
#define SCAN_THREADS 1024

static __device__ __forceinline__ unsigned lane_id() {
  return threadIdx.x & 31u;
}

// Pass 1: per-tile bucket counts, bucket-major.
__global__ void __launch_bounds__(RANK_THREADS)
count_kernel(const int32_t* __restrict__ buckets, int32_t* __restrict__ counts,
             int n, int B, int n_tiles) {
  __shared__ int s_count[MAX_BUCKETS];
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_count[b] = 0;
  __syncthreads();
  const long long tile0 = (long long)blockIdx.x * TILE;
  for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
    const long long row = tile0 + i;
    int b = -1;
    if (row < n) b = buckets[row];
    const bool ok = (b >= 0) && (b < B);
    const int key = ok ? b : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const unsigned leader = __ffs(peers) - 1;
    if (ok && lane_id() == leader) atomicAdd(&s_count[b], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    counts[(long long)b * n_tiles + blockIdx.x] = s_count[b];
}

// Exclusive scan of one value per thread over the whole block (blockDim.x a
// multiple of 32, at most 1024).  Returns the exclusive prefix; *total gets
// the block's sum.  Ends with a barrier so the scratch can be reused.
static __device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const unsigned lane = lane_id();
  const unsigned warp = threadIdx.x >> 5;
  const unsigned n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= (unsigned)o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= (unsigned)o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int inclusive = x + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[n_warps - 1];
  __syncthreads();
  return inclusive - v;
}

// Pass 2a: one CTA per bucket scans its row of tile counts in place and
// writes the bucket's total to hist.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles_kernel(int32_t* __restrict__ counts, int32_t* __restrict__ hist,
                  int n_tiles) {
  int32_t* row = counts + (long long)blockIdx.x * n_tiles;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n_tiles ? row[i] : 0;
    int total;
    const int ex = block_exclusive_scan(v, &total);
    if (i < n_tiles) row[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) hist[blockIdx.x] = carry;
}

// Pass 2b: exclusive scan of the histogram into bucket offsets (B <= 1024).
__global__ void __launch_bounds__(SCAN_THREADS)
scan_hist_kernel(const int32_t* __restrict__ hist, int32_t* __restrict__ offsets,
                 int B) {
  const int b = threadIdx.x;
  const int v = b < B ? hist[b] : 0;
  int total;
  const int ex = block_exclusive_scan(v, &total);
  if (b < B) offsets[b] = ex;
}

// Pass 3: stable ranks, written as bucket-major destinations.
__global__ void __launch_bounds__(RANK_THREADS)
rank_kernel(const int32_t* __restrict__ buckets, const int32_t* __restrict__ counts,
            const int32_t* __restrict__ offsets, int32_t* __restrict__ dest,
            int n, int B, int n_tiles) {
  __shared__ int s_cursor[MAX_BUCKETS];               // next slot per bucket
  __shared__ int s_warp[RANK_WARPS * MAX_BUCKETS];    // per-warp chunk counts
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    s_cursor[b] = offsets[b] + counts[(long long)b * n_tiles + blockIdx.x];
    for (int w = 0; w < RANK_WARPS; ++w) s_warp[w * B + b] = 0;
  }
  __syncthreads();
  const unsigned lane = lane_id();
  const unsigned warp = threadIdx.x >> 5;
  const unsigned lower_mask = (1u << lane) - 1u;
  const long long tile0 = (long long)blockIdx.x * TILE;
  for (int chunk = 0; chunk < TILE; chunk += RANK_THREADS) {
    const long long row = tile0 + chunk + threadIdx.x;
    if (tile0 + chunk >= n) break;                    // uniform over the CTA
    int b = -1;
    if (row < n) b = buckets[row];
    const bool ok = (b >= 0) && (b < B);
    const int key = ok ? b : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int below = __popc(peers & lower_mask);
    const bool leader = lane == (unsigned)(__ffs(peers) - 1);
    if (ok && leader) s_warp[warp * B + b] = __popc(peers);
    __syncthreads();
    if (ok) {
      int r = s_cursor[b] + below;
      for (unsigned w = 0; w < warp; ++w) r += s_warp[w * B + b];
      dest[row] = r;
    } else if (row < n) {
      dest[row] = -1;
    }
    __syncthreads();
    if (ok && leader) {
      atomicAdd(&s_cursor[b], __popc(peers));         // commutative: order-free
      s_warp[warp * B + b] = 0;
    }
    __syncthreads();
  }
}

// buckets, dest: (n,) int32; hist: (B,) int32; counts: (B * n_tiles,) int32
// scratch; offsets: (B,) int32 scratch.  n_tiles = ceil(n / TILE).
extern "C" int radix_partition_launch(const int32_t* buckets, int32_t* dest,
                                      int32_t* hist, int32_t* counts,
                                      int32_t* offsets, int n, int B,
                                      cudaStream_t stream) {
  if (n <= 0 || B < 1 || B > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)(((long long)n + TILE - 1) / TILE);
  count_kernel<<<n_tiles, RANK_THREADS, 0, stream>>>(buckets, counts, n, B,
                                                     n_tiles);
  scan_tiles_kernel<<<B, SCAN_THREADS, 0, stream>>>(counts, hist, n_tiles);
  scan_hist_kernel<<<1, SCAN_THREADS, 0, stream>>>(hist, offsets, B);
  rank_kernel<<<n_tiles, RANK_THREADS, 0, stream>>>(buckets, counts, offsets,
                                                    dest, n, B, n_tiles);
  return (int)cudaGetLastError();
}
