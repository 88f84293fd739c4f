// Online-softmax GQA attention for Hopper (sm_90a), bf16 or f32 inputs.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
// (with its `_kernel`), whose grid walks the kv blocks of one (batch, head,
// q block) in order and carries the running max m, sum l and accumulator acc
// in VMEM scratch.  Blocks on Hopper run in no order, so the kv walk becomes
// a loop inside one CTA: one CTA per (q tile of BLOCK_Q rows, head h, batch
// b), kv head h / group, looping over kv tiles of BLOCK_K rows staged in
// shared memory.  Tiles wholly above the causal diagonal are skipped (their
// weights are exactly 0); the causal mask is the TPU kernel's `cols <= rows`
// (top-left aligned), and the ragged Sq / Sk tails are masked in the kernel,
// so the wrapper pads nothing.  m, l and acc stay in f32; the output is
// written in the input dtype.  The q tiles that reach furthest along the
// diagonal have the most kv tiles, so they are started first.
//
// Bound: at the serving shapes (hd 128, thousands of rows) the work is the
// two products, 4 * hd FLOPs per unmasked (row, col) pair per head, against
// reading q, k, v and writing o once, so arithmetic bounds it.  Two kernels:
//
//   bf16: the products on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//         accumulate).  Four warps own 16 query rows each; Q stays in
//         registers as A fragments, S = Q K^T is 8-column C fragments, the
//         softmax runs on those fragments (four lanes share a row), and P is
//         repacked in registers as the A fragments of P V, as the TPU kernel
//         feeds p.astype(v.dtype) to its second product.  Tiles are copied
//         16 bytes a thread (the wrapper rejects rows that are not 16-byte
//         aligned), and V's B fragments come from row-major shared memory by
//         a transposing ldmatrix.
//   f32:  the products in f32 on the CUDA cores (FMA from shared memory), so
//         the result stays within 2e-5 of the plain version: a 16 x 16
//         thread grid, each thread a (BLOCK_Q/16) x (BLOCK_K/16) tile of S
//         and a (BLOCK_Q/16) x (hd/16) tile of acc, with the softmax's row
//         reductions through shared memory.
//
// Neither uses wgmma, TMA or a pipelined kv loop yet; PERF.md records the
// gap to the bound.  Every launch goes on the caller's stream; the entry
// point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// BLOCK_Q, BLOCK_K (tile rows) and MAX_HEAD_DIM come from the wrapper,
// ops.py, as -D flags: it rejects head dims the kernel was not built for.
#if !defined(BLOCK_Q) || !defined(BLOCK_K) || !defined(MAX_HEAD_DIM)
#error "build with -DBLOCK_Q=... -DBLOCK_K=... -DMAX_HEAD_DIM=... (kernels/flash_attention/ops.py)"
#endif
#define THREADS 256                          // f32 kernel
#define GRID 16                              // its 16 x 16 thread grid
#define ROWS_PER_THREAD (BLOCK_Q / GRID)
#define COLS_PER_THREAD (BLOCK_K / GRID)
#define THREADS_PER_ROW (THREADS / BLOCK_Q)  // softmax reducers per row
#define MMA_WARPS (BLOCK_Q / 16)             // bf16 kernel: 16 rows a warp

static_assert(BLOCK_Q % GRID == 0 && BLOCK_K % GRID == 0,
              "tiles must be multiples of 16 rows");
static_assert(THREADS % BLOCK_Q == 0 && THREADS_PER_ROW <= 32 &&
                  (THREADS_PER_ROW & (THREADS_PER_ROW - 1)) == 0,
              "BLOCK_Q must divide 256 into a power-of-two row group");
static_assert(BLOCK_K % THREADS_PER_ROW == 0, "softmax row split");
static_assert(MAX_HEAD_DIM == 16 || MAX_HEAD_DIM == 32 || MAX_HEAD_DIM == 64 ||
                  MAX_HEAD_DIM == 128,
              "MAX_HEAD_DIM is one of 16, 32, 64, 128");

// Element strides of the (B, S, heads, hd) tensors, hd contiguous:
// [batch, seq, head] for q, k, v and o in that order.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// The number of kv tiles q tile `q0` needs, and the q tile of a block.
static __device__ __forceinline__ int kv_tiles(int q0, int Sq, int Sk,
                                               int causal) {
  int n = (Sk + BLOCK_K - 1) / BLOCK_K;
  if (causal) n = min(n, (min(q0 + BLOCK_Q, Sq) - 1) / BLOCK_K + 1);
  return n;
}
static __device__ __forceinline__ int q_tile(int Sq, int causal) {
  const int n_qt = (Sq + BLOCK_Q - 1) / BLOCK_Q;
  return causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
// d = a * b + d, m16n8k16, bf16 inputs, f32 accumulators (PTX ISA fragment
// layouts: a row-major 16x16, b column-major 16x8, d 16x8).
static __device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

static __device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8.
static __device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                         const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Rows [r0, r0 + ROWS) of a (S, HD) slice with row stride ld_g, zero past
// row n, into shared rows of ld_s elements, 16 bytes a thread (the slice's
// rows are 16-byte aligned).
template <int HD, int ROWS>
static __device__ __forceinline__ void load_tile(
    __nv_bfloat16* __restrict__ dst, int ld_s,
    const __nv_bfloat16* __restrict__ src, long long ld_g, int r0, int n) {
  constexpr int CHUNKS = HD / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += blockDim.x) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld_g + c);
    *reinterpret_cast<uint4*>(dst + r * ld_s + c) = val;
  }
}

// Shared memory of the bf16 kernel, in bf16 elements: sQ[BLOCK_Q][ld],
// sK[BLOCK_K][ld], sV[BLOCK_K][ld], rows padded by 8 so that the fragment
// loads of one warp hit 32 different banks and rows stay 16-byte aligned.
template <int HD>
struct MmaSmem {
  static constexpr int ld = HD + 8;
  static constexpr int k_off = BLOCK_Q * ld;
  static constexpr int v_off = k_off + BLOCK_K * ld;
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * (v_off + BLOCK_K * ld);
};

template <int HD>
__global__ void __launch_bounds__(MMA_WARPS * 32)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, Strides st, int group,
                           int Sq, int Sk, int causal, float scale) {
  using L = MmaSmem<HD>;
  constexpr int NT = BLOCK_K / 8;     // 8-column tiles of S
  constexpr int KS = HD / 16;         // 16-deep steps of Q K^T
  constexpr int DT = HD / 8;          // 8-column tiles of acc
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf[];
  __nv_bfloat16* sQ = smem_bf;
  __nv_bfloat16* sK = smem_bf + L::k_off;
  __nv_bfloat16* sV = smem_bf + L::v_off;

  const int q0 = q_tile(Sq, causal) * BLOCK_Q;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;   // fragment row group, column pair

  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[2];
  const __nv_bfloat16* kb = k + b * st.k[0] + kh * st.k[2];
  const __nv_bfloat16* vb = v + b * st.v[0] + kh * st.v[2];
  __nv_bfloat16* ob = o + b * st.o[0] + h * st.o[2];

  load_tile<HD, BLOCK_Q>(sQ, L::ld, qb, st.q[1], q0, Sq);
  __syncthreads();
  uint32_t qa[KS][4];   // this warp's 16 rows of Q as A fragments
  {
    const __nv_bfloat16* base = sQ + (warp * 16 + g) * L::ld + t4 * 2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = ld32(base + ks * 16);
      qa[ks][1] = ld32(base + 8 * L::ld + ks * 16);
      qa[ks][2] = ld32(base + ks * 16 + 8);
      qa[ks][3] = ld32(base + 8 * L::ld + ks * 16 + 8);
    }
  }

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this lane's rows
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (same in the 4 lanes)
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the row sums
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_kt = kv_tiles(q0, Sq, Sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();  // the previous tile's readers are done with sK / sV
    load_tile<HD, BLOCK_K>(sK, L::ld, kb, st.k[1], k0, Sk);
    load_tile<HD, BLOCK_K>(sV, L::ld, vb, st.v[1], k0, Sk);
    __syncthreads();

    // S = Q K^T: B fragment (k = d, n = key) is K[key][d], a 32-bit pair
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sK + (nt * 8 + g) * L::ld + t4 * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_bf16(s[nt], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
    }

    // scale, mask, and the tile's row max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = k0 + nt * 8 + t4 * 2 + c;
        const bool ok0 = row0 < Sq && col < Sk && (!causal || col <= row0);
        const bool ok1 = row1 < Sq && col < Sk && (!causal || col <= row1);
        s[nt][c] = ok0 ? s[nt][c] * scale : -INFINITY;
        s[nt][2 + c] = ok1 ? s[nt][2 + c] * scale : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][c]);
        mx1 = fmaxf(mx1, s[nt][2 + c]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with nothing unmasked yet keeps m = -inf; exp(-inf - 0) = 0
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float corr0 = expf(m0 - mu0), corr1 = expf(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[nt][c] = expf(s[nt][c] - mu0);
        s[nt][2 + c] = expf(s[nt][2 + c] - mu1);
        sum0 += s[nt][c];
        sum1 += s[nt][2 + c];
      }
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr0;
      acc[j][1] *= corr0;
      acc[j][2] *= corr1;
      acc[j][3] *= corr1;
    }

    // acc += P V: P's C fragments of columns 16j..16j+15 are the A fragment
    // of step j; the B fragments (k = key, n = d) of two d tiles come from
    // row-major V in one transposing ldmatrix
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* vr = sV + (j * 16 + lane % 16) * L::ld + lane / 16 * 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vr + dt * 8);
        mma_bf16(acc[dt], pa, bv[0], bv[1]);
        mma_bf16(acc[dt + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + t4 * 2;
    if (row0 < Sq) {
      __nv_bfloat16* r = ob + (long long)row0 * st.o[1] + d;
      r[0] = __float2bfloat16(acc[dt][0] * inv0);
      r[1] = __float2bfloat16(acc[dt][1] * inv0);
    }
    if (row1 < Sq) {
      __nv_bfloat16* r = ob + (long long)row1 * st.o[1] + d;
      r[0] = __float2bfloat16(acc[dt][2] * inv1);
      r[1] = __float2bfloat16(acc[dt][3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
// Shared memory of the f32 kernel, in floats, for head dim HD.
template <int HD>
struct Smem {
  static constexpr int q_ld = HD + 1;        // sQ[BLOCK_Q][HD + 1]
  static constexpr int kt_ld = BLOCK_K + 1;  // sKt[HD][BLOCK_K + 1]
  static constexpr int p_ld = BLOCK_K + 1;   // sP[BLOCK_Q][BLOCK_K + 1]
  static constexpr int q_off = 0;
  static constexpr int kt_off = q_off + BLOCK_Q * q_ld;
  static constexpr int v_off = kt_off + HD * kt_ld;      // sV[BLOCK_K][HD]
  static constexpr int p_off = v_off + BLOCK_K * HD;
  static constexpr int m_off = p_off + BLOCK_Q * p_ld;
  static constexpr int l_off = m_off + BLOCK_Q;
  static constexpr int c_off = l_off + BLOCK_Q;
  static constexpr int floats = c_off + BLOCK_Q;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           Strides st, int group, int Sq, int Sk, int causal,
                           float scale) {
  using L = Smem<HD>;
  extern __shared__ float smem[];
  float* sQ = smem + L::q_off;
  float* sKt = smem + L::kt_off;
  float* sV = smem + L::v_off;
  float* sP = smem + L::p_off;
  float* sM = smem + L::m_off;
  float* sL = smem + L::l_off;
  float* sC = smem + L::c_off;

  const int q0 = q_tile(Sq, causal) * BLOCK_Q;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / group;
  const int tid = threadIdx.x, tx = tid % GRID, ty = tid / GRID;

  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* kb = k + b * st.k[0] + kh * st.k[2];
  const float* vb = v + b * st.v[0] + kh * st.v[2];
  float* ob = o + b * st.o[0] + h * st.o[2];

  for (int i = tid; i < BLOCK_Q * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    sQ[r * L::q_ld + d] = q0 + r < Sq ? qb[(long long)(q0 + r) * st.q[1] + d] : 0.f;
  }
  for (int r = tid; r < BLOCK_Q; r += THREADS) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }

  float acc[ROWS_PER_THREAD][HD / GRID];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
    for (int j = 0; j < HD / GRID; ++j) acc[i][j] = 0.f;

  const int n_kt = kv_tiles(q0, Sq, Sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();  // the previous tile's readers are done with sKt/sV/sP
    for (int i = tid; i < BLOCK_K * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < Sk;
      sKt[d * L::kt_ld + r] = in ? kb[(long long)(k0 + r) * st.k[1] + d] : 0.f;
      sV[r * HD + d] = in ? vb[(long long)(k0 + r) * st.v[1] + d] : 0.f;
    }
    __syncthreads();

    // S = Q K^T * scale, masked
    float s[ROWS_PER_THREAD][COLS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) {
      float a[ROWS_PER_THREAD], c[COLS_PER_THREAD];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
        a[i] = sQ[(ty + GRID * i) * L::q_ld + d];
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j)
        c[j] = sKt[d * L::kt_ld + tx + GRID * j];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
        for (int j = 0; j < COLS_PER_THREAD; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int r = ty + GRID * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j) {
        const int cl = tx + GRID * j, col = k0 + cl;
        const bool ok = row < Sq && col < Sk && (!causal || col <= row);
        sP[r * L::p_ld + cl] = ok ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: THREADS_PER_ROW neighbouring lanes per row
    {
      const int r = tid / THREADS_PER_ROW, part = tid % THREADS_PER_ROW;
      float* prow = sP + r * L::p_ld;
      float mx = -INFINITY;
      for (int c = part; c < BLOCK_K; c += THREADS_PER_ROW) mx = fmaxf(mx, prow[c]);
#pragma unroll
      for (int off = THREADS_PER_ROW / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int c = part; c < BLOCK_K; c += THREADS_PER_ROW) {
        const float p = expf(prow[c] - m_use);
        prow[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = THREADS_PER_ROW / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float corr = expf(m_old - m_use);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const float corr = sC[ty + GRID * i];
#pragma unroll
      for (int j = 0; j < HD / GRID; ++j) acc[i][j] *= corr;
    }
#pragma unroll 8
    for (int c = 0; c < BLOCK_K; ++c) {
      float p[ROWS_PER_THREAD], w[HD / GRID];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) p[i] = sP[(ty + GRID * i) * L::p_ld + c];
#pragma unroll
      for (int j = 0; j < HD / GRID; ++j) w[j] = sV[c * HD + tx + GRID * j];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
        for (int j = 0; j < HD / GRID; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int r = ty + GRID * i;
    if (q0 + r >= Sq) continue;
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
    float* orow = ob + (long long)(q0 + r) * st.o[1];
#pragma unroll
    for (int j = 0; j < HD / GRID; ++j) orow[tx + GRID * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <int HD>
static int launch(const void* q, const void* k, const void* v, void* o,
                  const Strides& st, int bf16, int B, int H, int KH, int Sq,
                  int Sk, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BLOCK_Q - 1) / BLOCK_Q, H, B);
  cudaError_t err;
  if (bf16) {
    auto kern = flash_attention_mma_kernel<HD>;
    const size_t bytes = MmaSmem<HD>::bytes;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, MMA_WARPS * 32, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), st,
        H / KH, Sq, Sk, causal, scale);
  } else {
    auto kern = flash_attention_f32_kernel<HD>;
    const size_t bytes = Smem<HD>::bytes;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), st, H / KH, Sq,
        Sk, causal, scale);
  }
  return (int)cudaGetLastError();
}

// q, o: (B, Sq, H, hd); k, v: (B, Sk, KH, hd), hd contiguous (in bf16,
// every row of q, k and v 16-byte aligned: pointer and strides), element
// strides in `strides` = [q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b,
// o_s, o_h] (a host array).  dtype 0 = float32, 1 = bfloat16.  H % KH == 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int dtype,
                                      int B, int H, int KH, int Sq, int Sk,
                                      int hd, int causal, float scale,
                                      cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || Sq <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, st, dtype, B, H, KH, Sq, Sk, causal, scale, stream);
    case 32:
      return launch<32>(q, k, v, o, st, dtype, B, H, KH, Sq, Sk, causal, scale, stream);
#if MAX_HEAD_DIM >= 64
    case 64:
      return launch<64>(q, k, v, o, st, dtype, B, H, KH, Sq, Sk, causal, scale, stream);
#endif
#if MAX_HEAD_DIM >= 128
    case 128:
      return launch<128>(q, k, v, o, st, dtype, B, H, KH, Sq, Sk, causal, scale, stream);
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
}
