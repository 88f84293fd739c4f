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
// Bound: B*S*D*N exponentials (MUFU, 16 a clock per SM) against reading dt
// and x and writing y once; at (1, 2048, 8192, 16) the exponentials take
// longer.  But at batch 1 the card has only B*D channels to spread, one
// recurrence per (channel, state), each step of it waiting on the one
// before, so what holds the scan back is the instructions around the MUFU,
// their latency, and the shared-memory words each thread reads a step
// (PERF.md).  The design, for each:
//
// - LANES threads share a channel, each holding PER_LANE of its states
//   (state n = j * LANES + lane): at d_inner 8192 and LANES 8 that is 16
//   warps an SM, two CTAs of at most 128 registers a thread.
// - y_t sums the lanes' partials.  Summed step by step that costs
//   log2(LANES) shuffles a step; instead a group of GROUP = LANES steps is
//   summed as a transpose-reduce: at each butterfly level a lane keeps the
//   half of its remaining partials that its lane bit names and sends the
//   other half to its partner, so GROUP steps cost GROUP - 1 shuffles, and
//   lane l ends with the whole of y at step t + l.
// - For a chunk of CHUNK steps, dt, dt * x (CHANNELS adjacent channels: one
//   coalesced row a step) and B_t, C_t are staged in shared memory as f32,
//   transposed so that a row holds one channel's or one state's steps and
//   one 16-byte load brings four of them.  Bm and Cm both bf16 (the
//   model's) are staged as one word a (state, step), C in the high half,
//   which cuts a thread's words a step from 2 + 2 PER_LANE to 2 + PER_LANE.
// - The next chunk is read into registers as raw words while this one is
//   computed, from pointers set once, and turned into f32 only when it is
//   stashed: a bf16 value converted right after its load would hold the
//   warp for the load's whole round trip.  y goes through shared memory
//   too, and out as coalesced rows.
// - The decay is one ex2.approx of dt * (A log2 e) instead of expf's nine
//   instructions (keep_a and decay below; PERF.md gives its accuracy).
//
// Every input is f32 or bf16 on its own (a flag each), read through its
// batch and step strides (rows contiguous), so the model's dt (f32 after
// softplus), x (bf16) and the column slices Bm, Cm of x_db go in as they
// are.  Ragged tails need no special path: a step past S or a state past N
// is staged as zeros, which leaves h unchanged (exp(0) = 1, no input) and
// adds nothing to y; those are never written out.  With h_out non-null the
// state after the last step is written (B, D, N) f32: the TPU kernel's
// scratch at the end of its grid, which a prefill hands to decode.
// Every launch goes on the caller's stream; the entry point returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// THREADS, LANES, MAX_STATE and CHUNK come from the wrapper, ops.py, as -D
// flags: it builds this source once per largest state size and rejects
// state sizes the kernel was not built for.
#if !defined(THREADS) || !defined(LANES) || !defined(MAX_STATE) || \
    !defined(CHUNK)
#error "build with -DTHREADS=... -DLANES=... -DMAX_STATE=... -DCHUNK=... (kernels/ssm_scan/ops.py)"
#endif
#define CHANNELS (THREADS / LANES)                   // channels per CTA
#define PER_LANE (MAX_STATE / LANES)                 // states per thread
#define GROUP LANES                                  // steps summed together
#define ROW (CHUNK + 4)                              // a staged row, padded
#define DX_PER_THREAD (CHUNK * CHANNELS / THREADS)   // staged dt, x values
#define BC_PER_THREAD (CHUNK * MAX_STATE / THREADS)  // staged B, C values

static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
static_assert(LANES >= 4 && LANES <= 32 && (LANES & (LANES - 1)) == 0,
              "a channel's lanes are a power-of-two group inside a warp, "
              "and a group of steps is whole 16-byte loads");
static_assert(MAX_STATE % LANES == 0, "states split evenly over the lanes");
static_assert((CHUNK * CHANNELS) % THREADS == 0 &&
                  (CHUNK * MAX_STATE) % THREADS == 0,
              "a chunk's staged values split evenly over the threads");
static_assert((DX_PER_THREAD & (DX_PER_THREAD - 1)) == 0 &&
                  (BC_PER_THREAD & (BC_PER_THREAD - 1)) == 0,
              "a thread stashes a power of two of steps at once");
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

// a raw word as f32: a bf16 value in the low half, an f32 value whole
__device__ __forceinline__ float word(unsigned r, int bf16) {
  return __uint_as_float(bf16 ? r << 16 : r);
}

// This thread's share of an input's (CHUNK, COLS) tile of a chunk: column
// c = tid % COLS at the K consecutive rows from s0 = (tid / COLS) * K, read
// as raw 32-bit words (0 past S or past the input's C columns).  A warp's
// load of one row is coalesced; the K values go to shared memory in one
// vector store.  The pointer and the masks are set once, so a chunk's fetch
// is a load a value; the dtype test sits outside the loop, and nothing
// reads a word until it is stashed, so all K loads are in flight at once
// while the chunk before is computed.
template <int K, int COLS>
struct Tile {
  const unsigned char* p;   // the value at row s0 of the next chunk
  long long row, chunk;     // bytes from a step to the next; a chunk on
  int c, s0, bf16;
  bool live;                // its column lies inside the input
  unsigned r[K];

  __device__ __forceinline__ Tile(const void* base, int is_bf16,
                                  long long b_off, long long s_stride, int c0,
                                  int C) {
    const int tid = threadIdx.x, es = is_bf16 ? 2 : 4;
    c = tid % COLS;
    s0 = tid / COLS * K;
    bf16 = is_bf16;
    live = c0 + c < C;
    p = static_cast<const unsigned char*>(base) +
        (b_off + s0 * s_stride + (live ? c0 + c : 0)) * es;
    row = s_stride * es;
    chunk = CHUNK * s_stride * es;
  }

  // the chunk whose first step lies `left` steps before S; then move on a
  // chunk
  __device__ __forceinline__ void fetch(int left) {
    left -= s0;
    if (bf16) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        r[k] = (live && k < left)
                   ? *reinterpret_cast<const unsigned short*>(p + k * row)
                   : 0u;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
        r[k] = (live && k < left)
                   ? *reinterpret_cast<const unsigned*>(p + k * row)
                   : 0u;
    }
    p += chunk;
  }

  // the k-th value as f32
  __device__ __forceinline__ float value(int k) const {
    return word(r[k], bf16);
  }
};

// K consecutive 32-bit values to shared memory, 16 bytes at a time
template <int K, class T>
__device__ __forceinline__ void store_row(T* dst, const T (&v)[K]) {
  static_assert(sizeof(T) == 4, "32-bit values");
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<uint4*>(dst + k) =
          make_uint4(__float_as_uint(v[k]), __float_as_uint(v[k + 1]),
                     __float_as_uint(v[k + 2]), __float_as_uint(v[k + 3]));
  } else if constexpr (K == 2) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(__float_as_uint(v[0]), __float_as_uint(v[1]));
  } else {
    dst[0] = v[0];
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// The decay exp(dt * A) from what the thread keeps of A, A log2(e): one
// ex2.approx of dt * (A log2 e), 2^z on the MUFU for any z, within a few
// ulp; the product's rounding adds |z| 2^-23 relative, which matters only
// where the decay is small and soon forgotten.  expf(dt * A), the plain
// version's torch.exp bit for bit, costs eight instructions more a (state,
// step): range reduction, 2^f on the MUFU, scaling.
__device__ __forceinline__ float keep_a(float A) {
  return A * 1.4426950408889634f;
}

__device__ __forceinline__ float decay(float dt, float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(dt * a));
  return r;
}

// PACKED: Bm and Cm both bf16, staged as one word a (state, step), C in
// the high half and B in the low, so a thread reads half as many words.
template <bool PACKED>
__global__ void __launch_bounds__(THREADS, 2) ssm_scan_kernel(const Args a) {
  __shared__ __align__(16) float s_dt[CHANNELS][ROW];
  __shared__ __align__(16) float s_dx[CHANNELS][ROW];    // dt * x
  __shared__ __align__(16) float s_b[MAX_STATE][ROW];    // or C|B packed
  __shared__ __align__(16) float s_c[PACKED ? 1 : MAX_STATE][ROW];
  __shared__ float s_y[CHUNK][CHANNELS + 4];

  const int tid = threadIdx.x;
  const int ch = tid / LANES, lane = tid % LANES;
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * CHANNELS;
  const int d = d0 + ch;
  const int S = a.S, D = a.D, N = a.N;

  // this thread's states n = j * LANES + lane; A is 0 past N (and past D),
  // so those states stay 0
  float A[PER_LANE], h[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int n = j * LANES + lane;
    A[j] = keep_a((d < D && n < N) ? load(a.A, d * a.a_d + n, a.a_bf16)
                                   : 0.f);
    h[j] = 0.f;
  }

  Tile<DX_PER_THREAD, CHANNELS> f_dt(a.dt, a.dt_bf16, b * a.dt_b, a.dt_s, d0,
                                     D);
  Tile<DX_PER_THREAD, CHANNELS> f_x(a.x, a.x_bf16, b * a.x_b, a.x_s, d0, D);
  Tile<BC_PER_THREAD, MAX_STATE> f_b(a.Bm, a.bm_bf16, b * a.bm_b, a.bm_s, 0,
                                     N);
  Tile<BC_PER_THREAD, MAX_STATE> f_c(a.Cm, a.cm_bf16, b * a.cm_b, a.cm_s, 0,
                                     N);
  auto fetch = [&](int t0) {
    f_dt.fetch(S - t0);
    f_x.fetch(S - t0);
    f_b.fetch(S - t0);
    f_c.fetch(S - t0);
  };
  auto stash = [&]() {
    float v_dt[DX_PER_THREAD], v_dx[DX_PER_THREAD];
#pragma unroll
    for (int k = 0; k < DX_PER_THREAD; ++k) {
      v_dt[k] = f_dt.value(k);
      v_dx[k] = v_dt[k] * f_x.value(k);
    }
    store_row(&s_dt[f_dt.c][f_dt.s0], v_dt);
    store_row(&s_dx[f_dt.c][f_dt.s0], v_dx);
    float v_b[BC_PER_THREAD], v_c[BC_PER_THREAD];
#pragma unroll
    for (int k = 0; k < BC_PER_THREAD; ++k) {
      v_b[k] = PACKED ? __uint_as_float(f_c.r[k] << 16 | f_b.r[k])
                      : f_b.value(k);
      v_c[k] = f_c.value(k);
    }
    store_row(&s_b[f_b.c][f_b.s0], v_b);
    if (!PACKED) store_row(&s_c[f_c.c][f_c.s0], v_c);
  };
  // y goes out as dt comes in, rows apart: column yc, rows ys0 + k * APART
  constexpr int APART = THREADS / CHANNELS;
  const int yc = tid % CHANNELS, ys0 = tid / CHANNELS;
  const bool y_live = d0 + yc < D;
  float* yp = a.y + (b * S + ys0) * D + d0 + yc;

  fetch(0);
  stash();
  __syncthreads();
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const bool more = t0 + CHUNK < S;
    if (more) fetch(t0 + CHUNK);   // in flight while this chunk computes

#pragma unroll
    for (int t = 0; t < CHUNK; t += GROUP) {
      // p[u]: this thread's share of y at step t + u
      float p[GROUP];
#pragma unroll
      for (int q = 0; q < GROUP; q += 4) {
        const float4 dt4 = load4(&s_dt[ch][t + q]);
        const float4 dx4 = load4(&s_dx[ch][t + q]);
        float4 b4[PER_LANE], c4[PER_LANE];
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          b4[j] = load4(&s_b[j * LANES + lane][t + q]);
          if (!PACKED) c4[j] = load4(&s_c[j * LANES + lane][t + q]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float dtv = part(dt4, u), dxv = part(dx4, u);
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < PER_LANE; ++j) {
            const unsigned w = __float_as_uint(part(b4[j], u));
            const float bv = PACKED ? __uint_as_float(w << 16) : part(b4[j], u);
            const float cv = PACKED ? __uint_as_float(w & 0xffff0000u)
                                    : part(c4[j], u);
            h[j] = fmaf(decay(dtv, A[j]), h[j], dxv * bv);
            acc = fmaf(h[j], cv, acc);
          }
          p[q + u] = acc;
        }
      }
      // transpose-reduce: at offset o a lane keeps the half of its m
      // partials that its bit o names (upper if set) and adds its
      // partner's copy of that half; after the last level p[0] holds y at
      // step t + lane
#pragma unroll
      for (int o = GROUP / 2, m = GROUP; o > 0; o /= 2, m /= 2) {
        const bool up = lane & o;
#pragma unroll
        for (int i = 0; i < m / 2; ++i) {
          const float send = up ? p[i] : p[i + m / 2];
          const float keep = up ? p[i + m / 2] : p[i];
          p[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      s_y[t + lane][ch] = p[0];
    }
    __syncthreads();

    const int left = S - t0 - ys0;
#pragma unroll
    for (int k = 0; k < DX_PER_THREAD; ++k) {
      const int r = k * APART;
      if (y_live && r < left) yp[(long long)r * D] = s_y[ys0 + r][yc];
    }
    yp += (long long)CHUNK * D;
    if (more) stash();
    __syncthreads();
  }

  if (a.h_out != nullptr && d < D) {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int n = j * LANES + lane;
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
  if (a.bm_bf16 && a.cm_bf16)
    ssm_scan_kernel<true><<<grid, THREADS, 0, stream>>>(a);
  else
    ssm_scan_kernel<false><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
