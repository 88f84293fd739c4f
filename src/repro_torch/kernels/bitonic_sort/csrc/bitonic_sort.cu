// Per-row ascending bitonic sort with an int32 payload, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitonic_sort/bitonic_sort.py::bitonic_sort_kernel (with
// `_kernel` and `_compare_exchange`), which holds one whole row in VMEM and
// runs every stage of the network on it, one grid step per row.  A row of
// 2^18 keys and payloads is 2 MB, far past the 227 KB of shared memory a
// CTA has, so the network is split by stride:
//
//   local   one CTA per chunk of SPAN = min(n, CHUNK) elements, held in
//           shared memory, runs every stage whose stride is below SPAN: at
//           first every size from 2 to SPAN, later the strides SPAN/2 .. 1
//           of one larger size;
//   global  one launch per (size, stride >= SPAN), one thread per pair,
//           straight from device memory.
//
// At n = 2^18 with CHUNK = 2^13 that is 1 + (2 + 3 + 4 + 5 + 6) = 21
// launches.  Every stage applies the TPU kernel's predicates to the same
// (size, stride) schedule: element i and its partner i ^ stride, ascending
// where bit `size` of i's index within its row is clear, the low element
// keeping itself where `a <= b` (ascending) or `a >= b` (descending), the
// high one where `b >= a` or `b <= a`.  Those two tests are one test (IEEE
// comparisons with a NaN are false both ways), so one thread per pair
// swaps both or neither, and the result does not depend on how a stage is
// split across threads: keys and payloads equal the plain version's bit for
// bit, ties, -0.0 / +0.0 and NaN included.  Rows lie end to end, so a row's
// index is the flat index masked by n - 1 (n a power of two).
//
// Bound: bytes.  At (4, 2^18) the function reads and writes keys and
// payloads once, 16.8 MB, 5.0 us at 3.35 TB/s.  The network does 4 x 2^17 x
// 171 = 89.7 M compare-exchanges, a compare and two selects each: 269 M
// operations, 4.0 us at the CUDA cores' 67 T a second, so the bytes bound
// it, narrowly.  This design reads and writes device memory once per
// global pass and once per local launch (21 passes at n = 2^18, some
// 350 MB), and runs 91 + 5 x 13 = 156 shared-memory stages, each ending
// in a __syncthreads; those passes, not the function's bytes, set its
// time (PERF.md).
//
// Each launch goes on the caller's stream; the entry point returns the
// first non-zero cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

// CHUNK (elements a CTA sorts in shared memory) and THREADS (threads a CTA)
// come from the wrapper, ops.py, as -D flags.
#if !defined(CHUNK) || !defined(THREADS)
#error "build with -DCHUNK=... -DTHREADS=... (kernels/bitonic_sort/ops.py)"
#endif
static_assert((CHUNK & (CHUNK - 1)) == 0 && CHUNK >= 2 * THREADS,
              "CHUNK is a power of two of at least 2 * THREADS");
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "THREADS");

// The TPU kernel's compare-exchange of the pair (a at i, b at i + stride).
template <typename T>
static __device__ __forceinline__ void exchange(T& a, T& b, int32_t& pa,
                                                int32_t& pb, bool ascending) {
  const bool keep = ascending ? (a <= b) : (a >= b);
  if (!keep) {
    const T k = a;
    a = b;
    b = k;
    const int32_t p = pa;
    pa = pb;
    pb = p;
  }
}

// Chunk blockIdx.x of the flat (rows * n) arrays, SPAN elements, in shared
// memory: size == 0 runs every size from 2 to SPAN, else the strides SPAN/2
// .. 1 of that size.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bitonic_local_kernel(T* __restrict__ keys, int32_t* __restrict__ payload,
                     long long n, int span, int size) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  int32_t* sp = reinterpret_cast<int32_t*>(smem + sizeof(T) * span);
  const long long base = (long long)blockIdx.x * span;
  const long long row_mask = n - 1;
  T* gk = keys + base;
  int32_t* gp = payload + base;
  if (span >= 4) {  // 16-byte copies: every chunk starts 16-byte aligned
    for (int i = threadIdx.x; i < span / 4; i += blockDim.x) {
      reinterpret_cast<uint4*>(sk)[i] = reinterpret_cast<const uint4*>(gk)[i];
      reinterpret_cast<uint4*>(sp)[i] = reinterpret_cast<const uint4*>(gp)[i];
    }
  } else {
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      sk[i] = gk[i];
      sp[i] = gp[i];
    }
  }
  __syncthreads();
  const int first = size ? size : 2, last = size ? size : span;
  for (int sz = first; sz <= last; sz <<= 1) {
    for (int stride = min(sz, span) / 2; stride >= 1; stride >>= 1) {
      for (int p = threadIdx.x; p < span / 2; p += blockDim.x) {
        const int lo = p & (stride - 1);
        const int i = ((p - lo) << 1) + lo;
        const bool ascending = (((base + i) & row_mask) & sz) == 0;
        exchange(sk[i], sk[i + stride], sp[i], sp[i + stride], ascending);
      }
      __syncthreads();
    }
  }
  if (span >= 4) {
    for (int i = threadIdx.x; i < span / 4; i += blockDim.x) {
      reinterpret_cast<uint4*>(gk)[i] = reinterpret_cast<const uint4*>(sk)[i];
      reinterpret_cast<uint4*>(gp)[i] = reinterpret_cast<const uint4*>(sp)[i];
    }
  } else {
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      gk[i] = sk[i];
      gp[i] = sp[i];
    }
  }
}

// One stage (size, stride) with stride >= SPAN: one thread per pair.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bitonic_global_kernel(T* __restrict__ keys, int32_t* __restrict__ payload,
                      long long pairs, long long n, long long size,
                      long long stride) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= pairs) return;
  const long long lo = p & (stride - 1);
  const long long i = ((p - lo) << 1) + lo, j = i + stride;
  T a = keys[i], b = keys[j];
  int32_t pa = payload[i], pb = payload[j];
  const bool ascending = ((i & (n - 1)) & size) == 0;
  const bool keep = ascending ? (a <= b) : (a >= b);
  if (!keep) {
    keys[i] = b;
    keys[j] = a;
    payload[i] = pb;
    payload[j] = pa;
  }
}

template <typename T>
static int run(T* keys, int32_t* payload, int rows, long long n,
               cudaStream_t stream) {
  const int span = (int)(n < CHUNK ? n : CHUNK);
  const long long total = rows * n;
  const int local_threads = span / 2 < THREADS ? (span / 2 + 31) / 32 * 32
                                               : THREADS;
  const size_t smem = (sizeof(T) + sizeof(int32_t)) * span;
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_local_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)((sizeof(T) + sizeof(int32_t)) * CHUNK));
  if (err != cudaSuccess) return (int)err;
  const long long chunks = total / span;
  const long long pair_blocks = (total / 2 + THREADS - 1) / THREADS;
  bitonic_local_kernel<T><<<(unsigned)chunks, local_threads, smem, stream>>>(
      keys, payload, n, span, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (long long size = 2LL * span; size <= n; size <<= 1) {
    for (long long stride = size / 2; stride >= span; stride >>= 1) {
      bitonic_global_kernel<T><<<(unsigned)pair_blocks, THREADS, 0, stream>>>(
          keys, payload, total / 2, n, size, stride);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    bitonic_local_kernel<T><<<(unsigned)chunks, local_threads, smem, stream>>>(
        keys, payload, n, span, (int)size);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// keys (rows, n) and payload (rows, n) int32, contiguous, sorted in place;
// n a power of two in [2, 2^30].  dtype 0 = int32 keys, 1 = float32.
extern "C" int bitonic_sort_launch(void* keys, int32_t* payload, int rows,
                                   long long n, int dtype,
                                   cudaStream_t stream) {
  if (rows <= 0 || n < 2 || n > (1LL << 30) || (n & (n - 1)) ||
      (dtype != 0 && dtype != 1) || rows * n / (n < CHUNK ? n : CHUNK) >
                                        0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run(static_cast<int32_t*>(keys), payload, rows, n, stream);
  return run(static_cast<float*>(keys), payload, rows, n, stream);
}
