// Online-softmax GQA attention for Hopper (sm_90a), bf16, f16 or f32 inputs.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
// (with its `_kernel`), whose grid walks the kv blocks of one (batch, head,
// q block) in order and carries the running max m, sum l and accumulator acc
// in VMEM scratch.  Blocks on Hopper run in no order, so the kv walk becomes
// a loop inside one CTA: one CTA per (q tile, head h, batch b), kv head
// h / group, looping over the kv tiles.  Tiles wholly above the causal
// diagonal are skipped (their weights are exactly 0); the causal mask is the
// TPU kernel's `cols <= rows` (top-left aligned), and the ragged Sq / Sk
// tails are masked in the kernel, so the wrapper pads nothing.  m, l and acc
// stay in f32; the output is written in the input dtype.  The q tiles that
// reach furthest along the diagonal have the most kv tiles, so they are
// started first.
//
// Bound: at the serving shapes (hd 128, thousands of rows) the work is the
// two products, 4 * hd FLOPs per unmasked (row, col) pair per head, against
// reading q, k, v and writing o once, so arithmetic bounds it.  Two kernels:
//
//   bf16 and f16: one template on the element type T (Elem below: the
//         wgmma's type name, P's and the output's rounding, the tensor
//         maps' data type).
//         Warp-specialised, on the tensor cores through wgmma, fed by TMA.
//         A CTA of 384 threads owns WG_BLOCK_Q = 128 query rows: two
//         consumer warpgroups of 64 rows each and one producer warpgroup,
//         of which one thread starts every copy.  The producer loads the Q
//         tile once, then K and V tiles of WG_BLOCK_K = 128 rows into a
//         ring of KV_STAGES slots in shared memory, each with a "full"
//         mbarrier (TMA completes its bytes there) and an "empty" one (the
//         256 consumer threads arrive when their products have read the
//         slot), so the next tiles are in flight while the tensor cores
//         work on this one.  The tensor maps are 4-D (hd, S, heads, batch)
//         views of the model layout built on the host from the wrapper's
//         strides; TMA zero-fills rows past Sq or Sk, and swizzles each
//         row of up to 128 bytes (64 of hd 128's columns, so a tile of hd
//         128 is two column blocks) as wgmma reads it.  Each consumer
//         warpgroup computes S = Q K^T with wgmma m64n128k16, Q and K both
//         K-major from shared memory; takes the online softmax on S's
//         registers (four lanes share a row) in the exp2 domain with
//         log2(e) folded into the scale, applying the causal and tail mask
//         only on the diagonal and tail tiles; repacks P as T A fragments
//         in registers, as the TPU kernel feeds p.astype(v.dtype) to its
//         second product; and adds P V with wgmma m64n{hd}k16, V
//         MN-major (row-major as stored, transposed by the descriptor).
//         setmaxnreg moves registers from the producer (24) to the
//         consumers (240), which hold S and acc (64 + hd / 2 f32 each).
//         Head dim 112 (zamba2's shared attention) runs on the hd-128
//         tiles: its tensor maps are 112 columns wide, so TMA zero-fills
//         columns 112-127 of the second 64-column box; Q K^T takes 7 k-steps
//         of 16 columns, P V still an n128 product whose last 16 columns
//         are zeros and are not stored: 1/16 of the arithmetic (the last
//         eighth of P V) is spent on padding.
//         The earlier design (mma.sync m16n8k16, 64-row tiles loaded
//         synchronously into one buffer, two scalar shared-memory loads per
//         product for K, expf) left the tensor cores idle while each tile
//         loaded and ran 6.9 times slower than PyTorch's
//         scaled_dot_product_attention (PERF.md).
//   f32:  the products in f32 on the CUDA cores (FMA from shared memory), so
//         the result stays within 2e-5 of the plain version: a 16 x 16
//         thread grid, each thread a (BLOCK_Q/16) x (BLOCK_K/16) tile of S
//         and a (BLOCK_Q/16) x (hd/16) tile of acc, with the softmax's row
//         reductions through shared memory.
//
// Every launch goes on the caller's stream; the entry point returns
// cudaGetLastError(), or 10000 + the CUresult if a tensor map cannot
// be built.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// BLOCK_Q, BLOCK_K (the f32 kernel's tile rows), WG_BLOCK_Q, WG_BLOCK_K,
// KV_STAGES (the tensor-core kernel's tiles and ring) and MAX_HEAD_DIM come
// from the wrapper, ops.py, as -D flags: it rejects head dims the kernel was
// not built for.
#if !defined(BLOCK_Q) || !defined(BLOCK_K) || !defined(MAX_HEAD_DIM) || \
    !defined(WG_BLOCK_Q) || !defined(WG_BLOCK_K) || !defined(KV_STAGES)
#error "build with -DBLOCK_Q=... -DBLOCK_K=... -DWG_BLOCK_Q=... -DWG_BLOCK_K=... -DKV_STAGES=... -DMAX_HEAD_DIM=... (kernels/flash_attention/ops.py)"
#endif
#define THREADS 256                          // f32 kernel
#define GRID 16                              // its 16 x 16 thread grid
#define ROWS_PER_THREAD (BLOCK_Q / GRID)
#define COLS_PER_THREAD (BLOCK_K / GRID)
#define THREADS_PER_ROW (THREADS / BLOCK_Q)  // softmax reducers per row
#define CONSUMERS 256                        // wgmma kernel: 2 warpgroups
#define WG_THREADS (CONSUMERS + 128)         // and the producer's

static_assert(BLOCK_Q % GRID == 0 && BLOCK_K % GRID == 0,
              "tiles must be multiples of 16 rows");
static_assert(THREADS % BLOCK_Q == 0 && THREADS_PER_ROW <= 32 &&
                  (THREADS_PER_ROW & (THREADS_PER_ROW - 1)) == 0,
              "BLOCK_Q must divide 256 into a power-of-two row group");
static_assert(BLOCK_K % THREADS_PER_ROW == 0, "softmax row split");
static_assert(MAX_HEAD_DIM == 16 || MAX_HEAD_DIM == 32 || MAX_HEAD_DIM == 64 ||
                  MAX_HEAD_DIM == 128,
              "MAX_HEAD_DIM is one of 16, 32, 64, 128");
static_assert(WG_BLOCK_Q == 2 * 64 && WG_BLOCK_K == 128,
              "the wgmma kernel takes 64 query rows per consumer warpgroup "
              "and S = Q K^T as one m64n128 product per 16 columns of hd");
static_assert(KV_STAGES >= 2 && KV_STAGES <= 4, "KV_STAGES is 2 to 4");

// Element strides of the (B, S, heads, hd) tensors, hd contiguous:
// [batch, seq, head] for q, k, v and o in that order.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// The number of kv tiles q tile `q0` needs, and the q tile of a block.
template <int BQ, int BK>
static __device__ __forceinline__ int kv_tiles(int q0, int Sq, int Sk,
                                               int causal) {
  int n = (Sk + BK - 1) / BK;
  if (causal) n = min(n, (min(q0 + BQ, Sq) - 1) / BK + 1);
  return n;
}
template <int BQ>
static __device__ __forceinline__ int q_tile(int Sq, int causal) {
  const int n_qt = (Sq + BQ - 1) / BQ;
  return causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
}

// ---------------------------------------------------------------------------
// bf16 and f16: wgmma fed by TMA
// ---------------------------------------------------------------------------
static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.  A wait
// that outlasts any real one (a broken ring) traps, so that the launch
// fails instead of hanging the card.
static __device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
static __device__ __forceinline__ void tma_load(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int c0, int c1,
                                                int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// After a wait: the registers a wgmma wrote are read only from here on.
template <int N>
static __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (1 = 128 B, 2 = 64 B, 3 = 32 B).
static __device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, int lbo,
                                                     int sbo, int layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// The element types of the tensor-core kernel: the PTX name of the type in
// a wgmma, two f32 values rounded to a pair of them in one word (P's A
// fragments, the output), and the tensor maps' data type.
template <class T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool f16 = false;
  static constexpr CUtensorMapDataType map_type =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <>
struct Elem<__half> {
  static constexpr bool f16 = true;
  static constexpr CUtensorMapDataType map_type =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// A wgmma of f32 accumulators from T operands: CALL("bf16") or CALL("f16"),
// the asm statement with the type's PTX name in its string.
#define WGMMA_TYPED(T, CALL)    \
  if constexpr (Elem<T>::f16) { \
    CALL("f16");                \
  } else {                      \
    CALL("bf16");               \
  }

// the accumulator operands of an m64nN product: N / 2 f32 registers
#define D8 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7])
#define D16 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define D32 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
    "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
    "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
    "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define D64 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
    "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
    "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
    "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
    "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
    "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
    "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
    "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
    "+f"(d[62]), "+f"(d[63])

// d (+)= A B^T, m64n128k16: A and B K-major in shared memory.
#define SS_N128(TY)                                                    \
  asm volatile(                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"    \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                               \
      : D64                                                            \
      : "l"(da), "l"(db), "r"(scale_d))
template <class T>
static __device__ __forceinline__ void wgmma_ss_n128(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  WGMMA_TYPED(T, SS_N128)
}

// d (+)= A B, m64nNk16: A in registers, B MN-major in shared memory; the
// scale predicate is operand P, the A fragment operands A0 to A0 + 3, the
// B descriptor A0 + 4.
#define RS(N, P, A0, A1, A2, A3, DB, DREGS, DOUT, TY)                    \
  asm volatile(                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                  \
      "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {"  \
      DREGS "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB         \
      ", p, 1, 1, 1;\n}\n"                                              \
      : DOUT                                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
#define REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define REGS16 REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define REGS32                                                          \
  REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
         "%28, %29, %30, %31"
#define REGS64                                                          \
  REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
         "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
         "%56, %57, %58, %59, %60, %61, %62, %63"
#define RS_N16(TY) RS(16, 13, 8, 9, 10, 11, 12, REGS8, D8, TY)
#define RS_N32(TY) RS(32, 21, 16, 17, 18, 19, 20, REGS16, D16, TY)
#define RS_N64(TY) RS(64, 37, 32, 33, 34, 35, 36, REGS32, D32, TY)
#define RS_N128(TY) RS(128, 69, 64, 65, 66, 67, 68, REGS64, D64, TY)

template <class T, int N>
static __device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  const int scale_d = 1;
  if constexpr (N == 16) {
    WGMMA_TYPED(T, RS_N16)
  } else if constexpr (N == 32) {
    WGMMA_TYPED(T, RS_N32)
  } else if constexpr (N == 64) {
    WGMMA_TYPED(T, RS_N64)
  } else {
    WGMMA_TYPED(T, RS_N128)
  }
}

// Shared memory of the wgmma kernel for head dim HD, in bytes from a
// 1024-byte aligned base.  A tile of R rows is HD * 2 / RB column blocks of
// R rows x RB bytes, each laid out (and swizzled) by TMA as wgmma reads it.
template <int HD>
struct WgSmem {
  static constexpr int RB = HD * 2 < 128 ? HD * 2 : 128;  // bytes of a row
  static constexpr int LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr int q_bytes = WG_BLOCK_Q * HD * 2;
  static constexpr int kv_bytes = WG_BLOCK_K * HD * 2;  // one K or V tile
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + KV_STAGES * kv_bytes;
  static constexpr int bar_off = v_off + KV_STAGES * kv_bytes;
  // q, then full[KV_STAGES], then empty[KV_STAGES]; 1024 bytes of slack to
  // align the base
  static constexpr size_t bytes = bar_off + 8 * (1 + 2 * KV_STAGES) + 1024;
  static_assert(q_bytes % 1024 == 0 && kv_bytes % 1024 == 0,
                "tiles keep the swizzle's 1024-byte alignment");
};

// T: the element type (__nv_bfloat16 or __half); HD: the tile's head dim
// (16, 32, 64 or 128); LHD: the tensors' own head dim, at most HD (112 on
// the hd-128 tiles; columns LHD..HD-1 of every tile are TMA's zero fill).
template <class T, int HD, int LHD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             T* __restrict__ o, long long o_b,
                             long long o_s, long long o_h, int group, int Sq,
                             int Sk, int causal, float scale_log2) {
  using L = WgSmem<HD>;
  constexpr int RB = L::RB;
  static_assert(LHD % 16 == 0 && LHD <= HD, "LHD: whole k-steps of a tile");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + L::k_off, sV = base + L::v_off;
  const uint32_t q_bar = base + L::bar_off;
  const uint32_t full_bar = q_bar + 8, empty_bar = full_bar + 8 * KV_STAGES;

  const int q0 = q_tile<WG_BLOCK_Q>(Sq, causal) * WG_BLOCK_Q;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / group;
  const int n_kt = kv_tiles<WG_BLOCK_Q, WG_BLOCK_K>(q0, Sq, Sk, causal);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_bar, L::q_bytes);
      for (int c = 0; c < HD * 2 / RB; ++c)
        tma_load(sQ + c * WG_BLOCK_Q * RB, &tq, q_bar, c * RB / 2, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % KV_STAGES;
        mbar_wait(empty_bar + 8 * s, ((kt / KV_STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, 2 * L::kv_bytes);
        for (int c = 0; c < HD * 2 / RB; ++c) {
          const uint32_t off = s * L::kv_bytes + c * WG_BLOCK_K * RB;
          tma_load(sK + off, &tk, full_bar + 8 * s, c * RB / 2,
                   kt * WG_BLOCK_K, kh, b);
          tma_load(sV + off, &tv, full_bar + 8 * s, c * RB / 2,
                   kt * WG_BLOCK_K, kh, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;              // 64 rows each
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;         // row group, column pair
    const int wg_row0 = q0 + wg * 64;
    const int row0 = wg_row0 + warp * 16 + g, row1 = row0 + 8;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max (same in 4 lanes)
    float l0 = 0.f, l1 = 0.f;              // this lane's part of the sums
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_bar, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % KV_STAGES, k0 = kt * WG_BLOCK_K;
      mbar_wait(full_bar + 8 * s, (kt / KV_STAGES) & 1);

      // S = Q K^T: 16 columns of hd a step (the zero-filled columns past
      // LHD skipped); a step moves 32 bytes along a swizzled row, or to the
      // next column block
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < LHD / 16; ++ks) {
        const int blk = ks * 32 / RB, in_row = ks * 32 % RB;
        const uint64_t dq = gmma_desc(
            sQ + blk * WG_BLOCK_Q * RB + wg * 64 * RB + in_row, 16, 8 * RB,
            L::LAYOUT);
        const uint64_t dk = gmma_desc(
            sK + s * L::kv_bytes + blk * WG_BLOCK_K * RB + in_row, 16,
            8 * RB, L::LAYOUT);
        wgmma_ss_n128<T>(sc, dq, dk, ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // the mask, only where a column can lie past Sk or above a row
      const bool masked = k0 + WG_BLOCK_K > Sk ||
                          (causal && k0 + WG_BLOCK_K - 1 > wg_row0);
      if (masked) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = k0 + j * 8 + t4 * 2 + c;
            if (col >= Sk || (causal && col > row0)) sc[4 * j + c] = -INFINITY;
            if (col >= Sk || (causal && col > row1))
              sc[4 * j + 2 + c] = -INFINITY;
          }
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with nothing unmasked yet keeps m = -inf; exp2(-inf - 0) = 0
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0 * scale_log2;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1 * scale_log2;
      const float corr0 = exp2f(m0 * scale_log2 - mu0);
      const float corr1 = exp2f(m1 * scale_log2 - mu1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[4 * j + c] = exp2f(fmaf(sc[4 * j + c], scale_log2, -mu0));
          sc[4 * j + 2 + c] = exp2f(fmaf(sc[4 * j + 2 + c], scale_log2, -mu1));
          sum0 += sc[4 * j + c];
          sum1 += sc[4 * j + 2 + c];
        }
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= corr0;
        acc[4 * j + 1] *= corr0;
        acc[4 * j + 2] *= corr1;
        acc[4 * j + 3] *= corr1;
      }

      // acc += P V: S's registers for columns 16k..16k+15 are the A
      // fragment of step k, rounded to T as the TPU kernel rounds p to
      // v.dtype; V's step k is its rows 16k..16k+15
      uint32_t pa[8][4];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[k][r] = Elem<T>::pack(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint64_t dv =
            gmma_desc(sV + s * L::kv_bytes + k * 16 * RB, WG_BLOCK_K * RB,
                      8 * RB, L::LAYOUT);
        wgmma_rs<T, HD>(acc, pa[k], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty_bar + 8 * s);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    T* ob = o + b * o_b + h * o_h;
#pragma unroll
    for (int j = 0; j < LHD / 8; ++j) {  // the columns past LHD are padding
      const int d = j * 8 + t4 * 2;
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * o_s + d) =
            Elem<T>::pack(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row1 * o_s + d) =
            Elem<T>::pack(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
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

  const int q0 = q_tile<BLOCK_Q>(Sq, causal) * BLOCK_Q;
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

  const int n_kt = kv_tiles<BLOCK_Q, BLOCK_K>(q0, Sq, Sk, causal);
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
// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D (hd, S, heads, B) map of 2-byte `type` elements of a tensor with
// element strides
// st = [batch, seq, head], boxes of rb bytes x `rows` rows, swizzled by rb.
// `hd` is the tensor's own width: a box reaching past it (hd 112 on the
// hd-128 tiles) is zero-filled.
// A dimension of size 1 may carry any stride in PyTorch; TMA wants a
// multiple of 16 bytes, so it gets the packed one.
static int make_map(CUtensorMap* map, CUtensorMapDataType type,
                    const void* ptr, int hd, int S, int heads, int B,
                    const long long st[3], int rows, int rb) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const long long elems[3] = {st[1], st[2], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] > 1 ? (cuuint64_t)elems[i] * 2
                 : i == 0        ? (cuuint64_t)hd * 2
                                 : strides[i - 1] * dims[i];
  const cuuint32_t box[4] = {(cuuint32_t)(rb / 2), (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = rb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, type, 4,
                            const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// The tensor-core kernel on T inputs (bf16 or f16) of head dim HD.
template <class T, int HD>
static int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                        const Strides& st, int B, int H, int KH, int Sq,
                        int Sk, int causal, float scale, cudaStream_t stream) {
  // the tiles' head dim: HD, or the next of 64 and 128 above it
  constexpr int TILE = HD <= 16 ? 16 : HD <= 32 ? 32 : HD <= 64 ? 64 : 128;
  using L = WgSmem<TILE>;
  constexpr CUtensorMapDataType type = Elem<T>::map_type;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, type, q, HD, Sq, H, B, st.q, WG_BLOCK_Q, L::RB);
  if (!e) e = make_map(&tk, type, k, HD, Sk, KH, B, st.k, WG_BLOCK_K, L::RB);
  if (!e) e = make_map(&tv, type, v, HD, Sk, KH, B, st.v, WG_BLOCK_K, L::RB);
  if (e) return e;
  auto kern = flash_attention_wgmma_kernel<T, TILE, HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + WG_BLOCK_Q - 1) / WG_BLOCK_Q, H, B);
  kern<<<grid, WG_THREADS, L::bytes, stream>>>(
      tq, tk, tv, static_cast<T*>(o), st.o[0], st.o[1], st.o[2], H / KH, Sq,
      Sk, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int HD>
static int launch(const void* q, const void* k, const void* v, void* o,
                  const Strides& st, int dtype, int B, int H, int KH, int Sq,
                  int Sk, int causal, float scale, cudaStream_t stream) {
  if (dtype == 1)
    return launch_wgmma<__nv_bfloat16, HD>(q, k, v, o, st, B, H, KH, Sq, Sk,
                                           causal, scale, stream);
  if (dtype == 2)
    return launch_wgmma<__half, HD>(q, k, v, o, st, B, H, KH, Sq, Sk, causal,
                                    scale, stream);
  auto kern = flash_attention_f32_kernel<HD>;
  const size_t bytes = Smem<HD>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BLOCK_Q - 1) / BLOCK_Q, H, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, H / KH, Sq,
      Sk, causal, scale);
  return (int)cudaGetLastError();
}

// q, o: (B, Sq, H, hd); k, v: (B, Sk, KH, hd), hd contiguous (in bf16 and
// f16, every row of q, k and v 16-byte aligned: pointer and strides, as TMA
// needs), element strides in `strides` = [q_b, q_s, q_h, k_b, k_s, k_h,
// v_b, v_s, v_h, o_b, o_s, o_h] (a host array).  dtype 0 = float32,
// 1 = bfloat16, 2 = float16.  H % KH == 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int dtype,
                                      int B, int H, int KH, int Sq, int Sk,
                                      int hd, int causal, float scale,
                                      cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || Sq <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535 || dtype < 0 || dtype > 2)
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
    case 112:
      return launch<112>(q, k, v, o, st, dtype, B, H, KH, Sq, Sk, causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, st, dtype, B, H, KH, Sq, Sk, causal, scale, stream);
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
}
