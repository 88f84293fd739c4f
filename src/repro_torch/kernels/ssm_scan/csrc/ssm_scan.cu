// Mamba1 selective scan for Hopper (sm_90a): f32 state carried over time.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ssm_scan/ssm_scan.py::ssm_scan_kernel (with its
// `_kernel`), whose grid (batch, d block, s chunk) walks the chunks of one
// (batch, d block) in order and carries the state h (d_block, N) in VMEM
// scratch from one chunk to the next.  Blocks on Hopper run in no order, so
// the chunk walk becomes a loop inside one CTA: one CTA per (block of
// CHANNELS channels, batch row), looping over time with h in registers.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = <h_t, C_t>
//
// LANES threads share a channel, each holding MAX_STATE / LANES of its
// states, so that batch 1 at d_inner 8192 still puts 32 768 threads on the
// card; y_t is summed across the lanes with __shfl_xor_sync.  For a chunk of
// CHUNK steps, dt and x (CHANNELS adjacent channels: one coalesced row a
// step) and B_t, C_t are staged in shared memory as f32.  The next chunk is
// read into registers as raw words while this one is computed, and turned
// into f32 only when it is stashed: a bf16 value converted right after its
// load would hold the warp for the load's whole round trip, one load after
// another.  Steps are computed GROUP at a time, phase by phase (inputs and
// exponentials, then the state's chain, then y's shuffles), so that their
// independent work overlaps; only h carries from one step to the next.  y
// goes through shared memory too, and out as coalesced rows.
//
// Every input is f32 or bf16 on its own (a flag each), read through its
// batch and step strides (rows contiguous), so the model's dt (f32 after
// softplus), x (bf16) and the column slices Bm, Cm of x_db go in as they
// are.  Ragged tails need no special path: a step past S or a state past N
// is staged as zeros, which leaves h unchanged (exp(0) = 1, no input) and
// adds nothing to y; those are never written out.  With h_out non-null the
// state after the last step is written (B, D, N) f32: the TPU kernel's
// scratch at the end of its grid, which a prefill hands to decode.
//
// Bound: B*S*D*N exponentials (MUFU, 16 a clock per SM) against reading dt
// and x and writing y once; at (1, 2048, 8192, 16) the exponentials take
// longer.  expf is the accurate one (eight instructions, one of them on the
// MUFU), so the kernel stays within 1e-5 of the plain version; at batch 1
// the kernel issues about 14 instructions per (step, state) from some 8
// warps an SM, and waits on latency more than on any one unit (PERF.md).
// Every launch goes on the caller's stream; the entry point returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// THREADS, LANES, MAX_STATE, CHUNK and GROUP come from the wrapper, ops.py,
// as -D flags: it rejects state sizes the kernel was not built for.
#if !defined(THREADS) || !defined(LANES) || !defined(MAX_STATE) || \
    !defined(CHUNK) || !defined(GROUP)
#error "build with -DTHREADS=... -DLANES=... -DMAX_STATE=... -DCHUNK=... -DGROUP=... (kernels/ssm_scan/ops.py)"
#endif
#define CHANNELS (THREADS / LANES)                   // channels per CTA
#define PER_LANE (MAX_STATE / LANES)                 // states per thread
#define DX_PER_THREAD (CHUNK * CHANNELS / THREADS)   // staged dt, x values
#define BC_PER_THREAD (CHUNK * MAX_STATE / THREADS)  // staged B, C values

static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
static_assert(LANES <= 32 && (LANES & (LANES - 1)) == 0,
              "a channel's lanes are a power-of-two group inside a warp");
static_assert(MAX_STATE % LANES == 0, "states split evenly over the lanes");
static_assert((CHUNK * CHANNELS) % THREADS == 0 &&
                  (CHUNK * MAX_STATE) % THREADS == 0,
              "a chunk's staged values split evenly over the threads");
static_assert(PER_LANE % 4 == 0 || PER_LANE < 4, "B and C read as float4");
static_assert(CHUNK % GROUP == 0, "a chunk is whole groups of steps");

struct Args {
  const void* dt;
  const void* A;
  const void* Bm;
  const void* Cm;
  const void* x;
  float* y;       // (B, S, D) contiguous
  float* h_out;   // (B, D, N) contiguous, or null
  long long dt_b, dt_s, x_b, x_s, bm_b, bm_s, cm_b, cm_s, a_d;
  int dt_bf16, a_bf16, bm_bf16, cm_bf16, x_bf16;
  int S, D, N;
};

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Read this thread's K values of a (CHUNK, COLS) tile starting at step t0
// and column c0 into raw 32-bit words (a bf16 value in the low half, an f32
// value whole; 0 past S or C).  The dtype test sits outside the loop and
// nothing reads a word until it is stashed, so all K loads are in flight at
// once while the chunk before is computed.
template <int K, int COLS>
__device__ __forceinline__ void fetch_tile(unsigned (&r)[K], const void* p,
                                           int bf16, long long base,
                                           long long s_stride, int t0, int c0,
                                           int S, int C) {
  const int tid = threadIdx.x;
  if (bf16) {
    const unsigned short* q = static_cast<const unsigned short*>(p) + base;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = tid + k * THREADS, s = t0 + e / COLS, c = c0 + e % COLS;
      r[k] = (s < S && c < C) ? q[s * s_stride + c] : 0u;
    }
  } else {
    const unsigned* q = static_cast<const unsigned*>(p) + base;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = tid + k * THREADS, s = t0 + e / COLS, c = c0 + e % COLS;
      r[k] = (s < S && c < C) ? q[s * s_stride + c] : 0u;
    }
  }
}

// ... and write them to the tile in shared memory as f32
template <int K, int COLS>
__device__ __forceinline__ void stash_tile(float (*tile)[COLS],
                                           const unsigned (&r)[K], int bf16) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = tid + k * THREADS;
    tile[e / COLS][e % COLS] = __uint_as_float(bf16 ? r[k] << 16 : r[k]);
  }
}

// PER_LANE consecutive f32 from shared memory, 16 bytes at a time
__device__ __forceinline__ void load_states(float (&v)[PER_LANE],
                                            const float* p) {
#pragma unroll
  for (int j = 0; j < PER_LANE; j += (PER_LANE % 4 == 0 ? 4 : 1)) {
    if constexpr (PER_LANE % 4 == 0) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    } else {
      v[j] = p[j];
    }
  }
}

__global__ void __launch_bounds__(THREADS) ssm_scan_kernel(const Args a) {
  __shared__ float s_dt[CHUNK][CHANNELS];
  __shared__ float s_x[CHUNK][CHANNELS];
  __shared__ float s_y[CHUNK][CHANNELS];
  __shared__ __align__(16) float s_b[CHUNK][MAX_STATE];
  __shared__ __align__(16) float s_c[CHUNK][MAX_STATE];

  const int tid = threadIdx.x;
  const int ch = tid / LANES, lane = tid % LANES;
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * CHANNELS;
  const int d = d0 + ch;
  const int S = a.S, D = a.D, N = a.N;

  // this thread's states n = lane * PER_LANE + j; A is 0 past N (and past
  // D), so those states stay 0
  float A[PER_LANE], h[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int n = lane * PER_LANE + j;
    A[j] = (d < D && n < N) ? load(a.A, d * a.a_d + n, a.a_bf16) : 0.f;
    h[j] = 0.f;
  }

  unsigned r_dt[DX_PER_THREAD], r_x[DX_PER_THREAD];
  unsigned r_b[BC_PER_THREAD], r_c[BC_PER_THREAD];
  auto fetch = [&](int t0) {
    fetch_tile<DX_PER_THREAD, CHANNELS>(r_dt, a.dt, a.dt_bf16, b * a.dt_b,
                                        a.dt_s, t0, d0, S, D);
    fetch_tile<DX_PER_THREAD, CHANNELS>(r_x, a.x, a.x_bf16, b * a.x_b,
                                        a.x_s, t0, d0, S, D);
    fetch_tile<BC_PER_THREAD, MAX_STATE>(r_b, a.Bm, a.bm_bf16, b * a.bm_b,
                                         a.bm_s, t0, 0, S, N);
    fetch_tile<BC_PER_THREAD, MAX_STATE>(r_c, a.Cm, a.cm_bf16, b * a.cm_b,
                                         a.cm_s, t0, 0, S, N);
  };
  auto stash = [&]() {
    stash_tile<DX_PER_THREAD, CHANNELS>(s_dt, r_dt, a.dt_bf16);
    stash_tile<DX_PER_THREAD, CHANNELS>(s_x, r_x, a.x_bf16);
    stash_tile<BC_PER_THREAD, MAX_STATE>(s_b, r_b, a.bm_bf16);
    stash_tile<BC_PER_THREAD, MAX_STATE>(s_c, r_c, a.cm_bf16);
  };

  fetch(0);
  stash();
  __syncthreads();
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const bool more = t0 + CHUNK < S;
    if (more) fetch(t0 + CHUNK);   // in flight while this chunk computes

    // GROUP steps at a time, phase by phase (their inputs and
    // exponentials, then the state's chain, then y's shuffles), so that
    // the steps' independent work overlaps: only h carries from one step
    // to the next
    for (int t = 0; t < CHUNK; t += GROUP) {
      float dA[GROUP][PER_LANE], bx[GROUP][PER_LANE], cv[GROUP][PER_LANE];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const float dtv = s_dt[t + u][ch];
        const float dtx = dtv * s_x[t + u][ch];
        float bv[PER_LANE];
        load_states(bv, &s_b[t + u][lane * PER_LANE]);
        load_states(cv[u], &s_c[t + u][lane * PER_LANE]);
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          dA[u][j] = expf(dtv * A[j]);
          bx[u][j] = dtx * bv[j];
        }
      }
      float yv[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        yv[u] = 0.f;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          h[j] = fmaf(dA[u][j], h[j], bx[u][j]);
          yv[u] = fmaf(h[j], cv[u][j], yv[u]);
        }
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off /= 2) {
#pragma unroll
        for (int u = 0; u < GROUP; ++u)
          yv[u] += __shfl_xor_sync(0xffffffffu, yv[u], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < GROUP; ++u) s_y[t + u][ch] = yv[u];
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < DX_PER_THREAD; ++k) {
      const int e = tid + k * THREADS;
      const int s = t0 + e / CHANNELS, dd = d0 + e % CHANNELS;
      if (s < S && dd < D)
        a.y[(b * S + s) * D + dd] = s_y[e / CHANNELS][e % CHANNELS];
    }
    if (more) stash();
    __syncthreads();
  }

  if (a.h_out != nullptr && d < D) {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int n = lane * PER_LANE + j;
      if (n < N) a.h_out[(b * D + d) * N + n] = h[j];
    }
  }
}

// strides: dt (b, s), x (b, s), Bm (b, s), Cm (b, s), A (d), in elements.
// dtypes: dt, A, Bm, Cm, x; 0 = float32, 1 = bfloat16.
extern "C" int ssm_scan_launch(const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* x, void* y,
                               void* h_out, const long long* strides,
                               const int* dtypes, int B, int S, int D, int N,
                               cudaStream_t stream) {
  if (B <= 0 || S <= 0 || D <= 0 || N <= 0 || N > MAX_STATE || B > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i)
    if (dtypes[i] != 0 && dtypes[i] != 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.dt = dt;
  a.A = A;
  a.Bm = Bm;
  a.Cm = Cm;
  a.x = x;
  a.y = static_cast<float*>(y);
  a.h_out = static_cast<float*>(h_out);
  a.dt_b = strides[0];
  a.dt_s = strides[1];
  a.x_b = strides[2];
  a.x_s = strides[3];
  a.bm_b = strides[4];
  a.bm_s = strides[5];
  a.cm_b = strides[6];
  a.cm_s = strides[7];
  a.a_d = strides[8];
  a.dt_bf16 = dtypes[0];
  a.a_bf16 = dtypes[1];
  a.bm_bf16 = dtypes[2];
  a.cm_bf16 = dtypes[3];
  a.x_bf16 = dtypes[4];
  a.S = S;
  a.D = D;
  a.N = N;
  const dim3 grid((D + CHANNELS - 1) / CHANNELS, B);
  ssm_scan_kernel<<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
