// Per-row ascending bitonic sort with an int32 payload, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitonic_sort/bitonic_sort.py::bitonic_sort_kernel (with
// `_kernel` and `_compare_exchange`), which holds one whole row in VMEM and
// runs every stage of the network on it, one grid step per row.  A row of
// 2^18 keys and payloads is 2 MB, far past the 227 KB of shared memory a
// CTA has, so the network runs in passes, each a launch of this kernel:
//
//   chunk   a pass gives each CTA the CHUNK = 2^LOG_CHUNK elements whose
//           flat indices (row * m + index) agree outside LOG_CHUNK "owned"
//           bits, and the CTA runs a consecutive run of the network's
//           stages whose stride bits it owns.  The wrapper (ops.py::plan)
//           cuts the network into the fewest such runs: 8 passes at
//           m = 2^18, against 21 launches of one stride or one chunk each
//           before.  Every pass owns the flat bits 0-2, so a warp's loads
//           and stores fill whole 32-byte sectors.  Between passes the
//           8.4 MB of the main shape stays in the 50 MB L2.
//   window  a thread holds E = 2^REG_BITS elements in registers: those
//           whose local indices differ in one window of REG_BITS
//           consecutive local bits (the other bits index the thread, lanes
//           first).  A stage whose stride bit lies in the window runs in
//           registers, one whose stride bit is a lane bit through
//           __shfl_xor_sync; for any other the chunk moves to another
//           window through shared memory (one 8-byte key/payload pair per
//           element, one 64-bit access, an 8-byte pad every E elements so
//           that no window's accesses conflict on a bank; two buffers, so
//           a move costs one barrier, the warp's own between windows 0-5).
//           The wrapper picks the windows by dynamic programming over the
//           stages, with per-op costs measured on the card.
//   ops     a pass arrives as a list of 32-bit ops (ops.py::_encode): a
//           run of register stages or of shuffle stages with the rule that
//           gives each pair's direction, maybe after a move.  Decoding an
//           op costs about as much as a stage's work, so runs and folded
//           moves keep the ops few (28 in the first pass at m = 2^18, 3-4
//           in each later one), and the first pass of any row longer than
//           a chunk, the same for every such row, is compiled in from
//           FIRST_OPS as straight-line code.  A stage's code is
//           specialised by its direction rule, so where that is one flag
//           for a warp or a bit of the register index, a compare-exchange
//           is one compare (a DPX min/max that also yields it, for int32
//           keys) and its selects.
//   launch  passes after the first launch as programmatic dependents: a
//           pass's CTAs start while the pass before drains, and wait for
//           its writes (griddepcontrol) before their first read.
//   pad     the first pass reads the caller's keys (row stride) and payload
//           or makes arange(n), and writes the pad (the dtype's max, payload
//           -1) past n, into fresh outputs: no PyTorch launch before the
//           sort, and the caller's tensors are never written.
//
// Every stage applies the TPU kernel's predicates to the same (size,
// stride) schedule: element i and its partner i ^ stride, ascending where
// bit `size` of i's index within its row is clear, the low element keeping
// itself where `a <= b` (ascending) or `a >= b` (descending), the high one
// where `b >= a` or `b <= a`.  Those two tests are one test (IEEE
// comparisons with a NaN are false both ways), so both elements swap or
// neither, whichever thread computes them: keys and payloads equal the plain
// version's bit for bit, ties, -0.0 / +0.0 and NaN included.
//
// Bound: bytes.  At (4, 2^18) the function reads and writes keys and
// payloads once, 16.8 MB, 5.0 us at 3.35 TB/s.  The network does 4 x 2^17 x
// 171 = 89.7 M compare-exchanges, a compare and two selects each: 269 M
// operations, 4.0 us at the CUDA cores' 67 T a second.  This design's time
// is its passes and its stages: measured on an H100, a pass that only loads
// and stores costs about 5.9 us, decoding an op about 0.16 us, a stage's
// work in registers about 0.15 us, through shuffles or a move through
// shared memory about 0.5 us (PERF.md).
//
// Each launch goes on the caller's stream; the entry point returns the
// first non-zero cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// LOG_CHUNK, REG_BITS, MAX_OPS, FIRST_W0 and FIRST_OPS come from the
// wrapper, ops.py, as -D flags.
#if !defined(LOG_CHUNK) || !defined(REG_BITS) || !defined(MAX_OPS) || \
    !defined(FIRST_W0) || !defined(FIRST_OPS)
#error "build with the -D flags of ops.py::DEFINES"
#endif
constexpr int CHUNK = 1 << LOG_CHUNK;
constexpr int E = 1 << REG_BITS;            // elements a thread holds
constexpr int THREADS = CHUNK >> REG_BITS;
constexpr int PADDED = CHUNK + CHUNK / E;   // one buffer, in 8-byte pairs
static_assert(REG_BITS >= 1 && REG_BITS <= 5, "reg_run's cases");
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "THREADS");

// ops.py's encoding
enum { OP_REG = 0, OP_SHFL = 1, OP_RELAYOUT = 2 };
enum { DIR_ASC = 0, DIR_REG = 1, DIR_THREAD = 2, DIR_CTA = 3 };

// One pass, passed by value.
struct Pass {
  unsigned long long owned_mask;  // the flat bits a CTA owns
  signed char owned[LOG_CHUNK];   // the flat bit of each local bit
  signed char w0;                 // the window the pass loads in
  short n_ops;
  unsigned ops[MAX_OPS];
};

template <typename T> struct Key;
template <> struct Key<int32_t> {
  static __device__ __forceinline__ unsigned bits(int32_t v) {
    return (unsigned)v;
  }
  static __device__ __forceinline__ int32_t of(unsigned u) {
    return (int32_t)u;
  }
  static __device__ __forceinline__ int32_t max() { return 0x7fffffff; }
};
template <> struct Key<float> {
  static __device__ __forceinline__ unsigned bits(float v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ float of(unsigned u) {
    return __uint_as_float(u);
  }
  static __device__ __forceinline__ float max() { return 3.402823466e38f; }
};

// The TPU kernel's compare-exchange of the pair (a low, b high).
template <typename T>
static __device__ __forceinline__ void exchange(T& a, T& b, int32_t& pa,
                                                int32_t& pb, bool desc) {
  const bool keep = desc ? (a >= b) : (a <= b);
  const T ka = a, kb = b;
  const int32_t qa = pa, qb = pb;
  a = keep ? ka : kb;
  b = keep ? kb : ka;
  pa = keep ? qa : qb;
  pb = keep ? qb : qa;
}

// How a stage's pairs find their direction, once decoded: all ascending,
// all descending, by a per-thread flag that differs between lanes
// (MODE_VAR), or by bit P of the register index (MODE_PAT + P).
enum { MODE_ASC = 0, MODE_DESC = 1, MODE_VAR = 2, MODE_PAT = 3 };

template <int MODE>
static __device__ __forceinline__ bool direction(int r, bool var) {
  if constexpr (MODE == MODE_ASC) return false;
  else if constexpr (MODE == MODE_DESC) return true;
  else if constexpr (MODE == MODE_VAR) return var;
  else return (r >> (MODE - MODE_PAT)) & 1;
}

// int32 keys: a DPX min or max that also yields the low element's test.
template <>
__device__ __forceinline__ void exchange<int32_t>(int32_t& a, int32_t& b,
                                                  int32_t& pa, int32_t& pb,
                                                  bool desc) {
  bool keep;
  const int32_t lo = desc ? __vibmax_s32(a, b, &keep)
                          : __vibmin_s32(a, b, &keep);
  const int32_t hi = (int32_t)((unsigned)a + (unsigned)b - (unsigned)lo);
  const int32_t qa = pa, qb = pb;
  a = lo;
  b = hi;
  pa = keep ? qa : qb;
  pb = keep ? qb : qa;
}

// One stage whose stride is register bit Q.  For every mode but MODE_VAR
// each pair's direction is a constant here, so a compare-exchange is one
// compare and four selects.
template <int Q, int MODE, typename T>
static __device__ __forceinline__ void reg_stage(T (&k)[E], int32_t (&p)[E],
                                                 bool var) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (r & (1 << Q)) continue;
    exchange(k[r], k[r | (1 << Q)], p[r], p[r | (1 << Q)],
             direction<MODE>(r, var));
  }
}

#define PAT_CASES(CALL)                                  \
  case MODE_PAT + 0: CALL(MODE_PAT + 0 % REG_BITS); break; \
  case MODE_PAT + 1: CALL(MODE_PAT + 1 % REG_BITS); break; \
  case MODE_PAT + 2: CALL(MODE_PAT + 2 % REG_BITS); break; \
  case MODE_PAT + 3: CALL(MODE_PAT + 3 % REG_BITS); break; \
  case MODE_PAT + 4: CALL(MODE_PAT + 4 % REG_BITS); break;

// A run of register stages, strides qh, qh - 1, .. (c of them), with one
// direction rule: decoded once, each stage then a uniform branch.
template <int MODE, typename T>
static __device__ __forceinline__ void reg_run(T (&k)[E], int32_t (&p)[E],
                                               int qh, int c, bool var) {
  switch (qh) {
#if REG_BITS > 4
    case 4:
      reg_stage<4, MODE>(k, p, var);
      if (--c == 0) break;
      [[fallthrough]];
#endif
#if REG_BITS > 3
    case 3:
      reg_stage<3, MODE>(k, p, var);
      if (--c == 0) break;
      [[fallthrough]];
#endif
#if REG_BITS > 2
    case 2:
      reg_stage<2, MODE>(k, p, var);
      if (--c == 0) break;
      [[fallthrough]];
#endif
#if REG_BITS > 1
    case 1:
      reg_stage<1, MODE>(k, p, var);
      if (--c == 0) break;
      [[fallthrough]];
#endif
    case 0:
      reg_stage<0, MODE>(k, p, var);
      break;
    default:
      break;
  }
}

template <typename T>
static __device__ __forceinline__ void reg_run_m(T (&k)[E], int32_t (&p)[E],
                                                 int qh, int c, int mode,
                                                 bool var) {
#define CALL(M) reg_run<M>(k, p, qh, c, var)
  switch (mode) {
    case MODE_ASC: CALL(MODE_ASC); break;
    case MODE_DESC: CALL(MODE_DESC); break;
    case MODE_VAR: CALL(MODE_VAR); break;
    PAT_CASES(CALL)
    default: break;
  }
#undef CALL
}

// One stage whose stride is lane bit `lb`: each thread keeps its element or
// takes its partner's, by the same test its partner makes.
template <int MODE, typename T>
static __device__ __forceinline__ void shfl_stage(T (&k)[E], int32_t (&p)[E],
                                                  int lb, bool var) {
  const int xm = 1 << lb;
  const bool high = (threadIdx.x & xm) != 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const T pk = __shfl_xor_sync(0xffffffffu, k[r], xm);
    const int32_t pp = __shfl_xor_sync(0xffffffffu, p[r], xm);
    // the low element's test, a <= b or a >= b, seen from either side
    const bool flip = direction<MODE>(r, var) != high;
    const bool keep = flip ? (k[r] >= pk) : (k[r] <= pk);
    k[r] = keep ? k[r] : pk;
    p[r] = keep ? p[r] : pp;
  }
}

// A run of shuffle stages, lane bits lb, lb - 1, .. (c of them), with one
// direction rule.
template <int MODE, typename T>
static __device__ __forceinline__ void shfl_run(T (&k)[E], int32_t (&p)[E],
                                                int lb, int c, bool var) {
  for (int s = 0; s < c; ++s) shfl_stage<MODE>(k, p, lb - s, var);
}

template <typename T>
static __device__ __forceinline__ void shfl_run_m(T (&k)[E], int32_t (&p)[E],
                                                  int lb, int c, int mode,
                                                  bool var) {
#define CALL(M) shfl_run<M>(k, p, lb, c, var)
  switch (mode) {
    case MODE_ASC: CALL(MODE_ASC); break;
    case MODE_DESC: CALL(MODE_DESC); break;
    case MODE_VAR: CALL(MODE_VAR); break;
    PAT_CASES(CALL)
    default: break;
  }
#undef CALL
}
#undef PAT_CASES

// The local index of this thread's register 0 in window w; register r adds
// r << w.
static __device__ __forceinline__ int local_base(int w) {
  const int t = threadIdx.x;
  return (t & ((1 << w) - 1)) | ((t >> w) << (w + REG_BITS));
}

// Shared-memory slot of local index l: an 8-byte pad after every E, which
// keeps every window's accesses free of bank conflicts.  The thread's part
// and the register's part of l share no bit, so the slot is the sum of
// their slots; with the window known, each register's part is an
// immediate offset.
static __device__ __forceinline__ int slot(int l) {
  return l + (l >> REG_BITS);
}

template <int W, typename T>
static __device__ __forceinline__ void store_window(uint2* s, const T (&k)[E],
                                                    const int32_t (&p)[E]) {
  uint2* b = s + slot(local_base(W));
#pragma unroll
  for (int r = 0; r < E; ++r)
    b[slot(r << W)] = make_uint2(Key<T>::bits(k[r]), (unsigned)p[r]);
}

template <int W, typename T>
static __device__ __forceinline__ void load_window(const uint2* s, T (&k)[E],
                                                   int32_t (&p)[E]) {
  const uint2* b = s + slot(local_base(W));
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const uint2 v = b[slot(r << W)];
    k[r] = Key<T>::of(v.x);
    p[r] = (int32_t)v.y;
  }
}

constexpr int N_WINDOWS = LOG_CHUNK - REG_BITS + 1;
static_assert(N_WINDOWS <= 12, "windows 0 .. 11");

#define W_CASES(CALL)                                                  \
  case 0: CALL(0 % N_WINDOWS); break;   case 1: CALL(1 % N_WINDOWS); break; \
  case 2: CALL(2 % N_WINDOWS); break;   case 3: CALL(3 % N_WINDOWS); break; \
  case 4: CALL(4 % N_WINDOWS); break;   case 5: CALL(5 % N_WINDOWS); break; \
  case 6: CALL(6 % N_WINDOWS); break;   case 7: CALL(7 % N_WINDOWS); break; \
  case 8: CALL(8 % N_WINDOWS); break;   case 9: CALL(9 % N_WINDOWS); break; \
  case 10: CALL(10 % N_WINDOWS); break; case 11: CALL(11 % N_WINDOWS); break;

// Move the chunk from window w to window w2 through buffer s.  In a window
// of at most 5 a warp's registers and lanes cover local bits 0 ..
// REG_BITS + 4, so between two such windows each warp moves only its own
// elements and waits only for itself.  (Every buffer a warp writes was last
// read two moves before; a move that reads other warps' elements waits for
// the whole CTA, and so does any move before a write to their slots.)
template <typename T>
static __device__ __forceinline__ void relayout(uint2* s, T (&k)[E],
                                                int32_t (&p)[E], int w,
                                                int w2) {
#define CALL(W) store_window<W>(s, k, p)
  switch (w) {
    W_CASES(CALL)
    default: break;
  }
#undef CALL
  if (w <= 5 && w2 <= 5)
    __syncwarp();
  else
    __syncthreads();
#define CALL(W) load_window<W>(s, k, p)
  switch (w2) {
    W_CASES(CALL)
    default: break;
  }
#undef CALL
}
#undef W_CASES

// The flat bits of local index l.
static __device__ __forceinline__ long long deposit(const Pass& ps, int l) {
  long long f = 0;
#pragma unroll
  for (int b = 0; b < LOG_CHUNK; ++b)
    if ((l >> b) & 1) f |= 1LL << ps.owned[b];
  return f;
}

// The first pass of every row longer than a chunk runs the same ops
// (sizes 2 .. CHUNK on whole chunks); the wrapper passes them as FIRST_OPS
// and FIRST_W0, and they compile into straight-line code here: no op to
// decode, and the compiler schedules across stages.
#define FIRST_OP(op) op,   // FIRST_OPS is FIRST_OP(a)FIRST_OP(b)..: nvcc
                            // splits a -D value at its commas
constexpr unsigned kFirstOps[] = {FIRST_OPS};
#undef FIRST_OP
constexpr int kFirstN = sizeof(kFirstOps) / sizeof(kFirstOps[0]);

__host__ __device__ constexpr bool op_moves(unsigned op) {
  return (op & 3) == OP_RELAYOUT || ((op >> 17) & 1);
}
__host__ __device__ constexpr int op_window(unsigned op) {
  return (op & 3) == OP_RELAYOUT ? (op >> 2) & 15 : (op >> 18) & 15;
}
// the window before first-pass op i, and the buffer its move writes
__host__ __device__ constexpr int first_window(int i) {
  int w = FIRST_W0;
  for (int j = 0; j < i; ++j)
    if (op_moves(kFirstOps[j])) w = op_window(kFirstOps[j]);
  return w;
}
__host__ __device__ constexpr int first_buffer(int i) {
  int b = 0;
  for (int j = 0; j < i; ++j)
    if (op_moves(kFirstOps[j])) b ^= 1;
  return b;
}

template <int KIND, int ARG, int C, int MODE, typename T>
static __device__ __forceinline__ void static_run(T (&k)[E], int32_t (&p)[E],
                                                  bool var) {
  if constexpr (KIND == OP_REG)
    reg_stage<ARG, MODE>(k, p, var);
  else
    shfl_stage<MODE>(k, p, ARG, var);
  if constexpr (C > 1) static_run<KIND, ARG - 1, C - 1, MODE>(k, p, var);
}

template <int I, typename T>
static __device__ __forceinline__ void first_ops(uint2* smem, T (&k)[E],
                                                 int32_t (&p)[E],
                                                 long long base) {
  if constexpr (I < kFirstN) {
    constexpr unsigned op = kFirstOps[I];
    constexpr int kind = op & 3, arg = (op >> 2) & 15;
    if constexpr (op_moves(op)) {
      constexpr int w = first_window(I), w2 = op_window(op);
      uint2* s = smem + first_buffer(I) * PADDED;
      store_window<w>(s, k, p);
      if constexpr (w <= 5 && w2 <= 5)
        __syncwarp();
      else
        __syncthreads();
      load_window<w2>(s, k, p);
    }
    if constexpr (kind != OP_RELAYOUT) {
      constexpr int dkind = (op >> 6) & 3, darg = (op >> 8) & 63;
      constexpr int c = (int)((op >> 14) & 7) + 1;
      if constexpr (dkind == DIR_ASC) {
        static_run<kind, arg, c, MODE_ASC>(k, p, false);
      } else if constexpr (dkind == DIR_REG) {
        static_run<kind, arg, c, MODE_PAT + darg>(k, p, false);
      } else if constexpr (dkind == DIR_THREAD && darg < 5) {
        static_run<kind, arg, c, MODE_VAR>(k, p, (threadIdx.x >> darg) & 1);
      } else {       // one flag for the warp: a branch that does not diverge
        const bool desc = dkind == DIR_THREAD ? (threadIdx.x >> darg) & 1
                                              : (base >> darg) & 1;
        if (desc)
          static_run<kind, arg, c, MODE_DESC>(k, p, false);
        else
          static_run<kind, arg, c, MODE_ASC>(k, p, false);
      }
    }
    first_ops<I + 1>(smem, k, p, base);
  }
}

// Pass `ps` over the flat (rows * 2^log_m) arrays: FIRST reads the caller's
// keys and payload (or arange(n)) and pads past n; later passes read and
// write keys / payload in place.
template <typename T, bool FIRST, bool STATIC>
__global__ void __launch_bounds__(THREADS, 1)
bitonic_pass_kernel(const T* __restrict__ keys_in, long long key_stride,
                    const int32_t* __restrict__ pay_in, long long pay_stride,
                    T* keys, int32_t* payload, long long rows, long long n,
                    int log_m, const __grid_constant__ Pass ps) {
  extern __shared__ __align__(16) uint2 smem[];
  const long long m = 1LL << log_m, total = rows << log_m;
  // the chunk's own flat bits: blockIdx.x spread over the bits not owned
  long long base = 0;
  {
    unsigned long long c = blockIdx.x;
    for (int b = 0; c && b < 63; ++b) {
      if ((ps.owned_mask >> b) & 1) continue;
      if (c & 1) base |= 1LL << b;
      c >>= 1;
    }
  }
  // a later pass may start while the one before drains (programmatic
  // dependent launch): wait for its writes before the first read
  if constexpr (!FIRST) asm volatile("griddepcontrol.wait;" ::: "memory");
  T k[E];
  int32_t p[E];
  int w = ps.w0;
  long long off[REG_BITS];
#pragma unroll
  for (int q = 0; q < REG_BITS; ++q) off[q] = 1LL << ps.owned[w + q];
  const long long tflat = base + deposit(ps, local_base(w));
#pragma unroll
  for (int r = 0; r < E; ++r) {
    long long f = tflat;
#pragma unroll
    for (int q = 0; q < REG_BITS; ++q)
      if ((r >> q) & 1) f += off[q];
    if (FIRST) {
      const long long row = f >> log_m, idx = f & (m - 1);
      const bool in = f < total && idx < n;
      k[r] = in ? keys_in[row * key_stride + idx] : Key<T>::max();
      p[r] = in ? (pay_in ? pay_in[row * pay_stride + idx] : (int32_t)idx)
                : -1;
    } else {
      k[r] = keys[f];
      p[r] = payload[f];
    }
  }
  int buf = 0;
  if constexpr (STATIC) {
    first_ops<0>(smem, k, p, base);
    constexpr int end = first_window(kFirstN);
    w = end;
  }
  for (int i = 0; i < (STATIC ? 0 : ps.n_ops); ++i) {
    const unsigned op = ps.ops[i];
    const int kind = op & 3, arg = (op >> 2) & 15;
    if (kind == OP_RELAYOUT || ((op >> 17) & 1)) {   // a move, maybe first
      const int w2 = kind == OP_RELAYOUT ? arg : (int)((op >> 18) & 15);
      relayout(smem + buf * PADDED, k, p, w, w2);
      w = w2;
      buf ^= 1;
      if (kind == OP_RELAYOUT) continue;
    }
    // the direction: a register bit (a pattern), a lane bit (a flag per
    // thread), or one flag for the whole warp (a branch that does not
    // diverge)
    const int dkind = (op >> 6) & 3, darg = (op >> 8) & 63;
    int mode = MODE_ASC;
    bool var = false;
    if (dkind == DIR_REG) {
      mode = MODE_PAT + darg;
    } else if (dkind == DIR_THREAD) {
      var = (threadIdx.x >> darg) & 1;
      mode = darg < 5 ? MODE_VAR : (var ? MODE_DESC : MODE_ASC);
    } else if (dkind == DIR_CTA) {
      mode = ((base >> darg) & 1) ? MODE_DESC : MODE_ASC;
    }
    const int count = (int)((op >> 14) & 7) + 1;
    if (kind == OP_SHFL)
      shfl_run_m(k, p, arg, count, mode, var);
    else
      reg_run_m(k, p, arg, count, mode, var);
  }
#pragma unroll
  for (int q = 0; q < REG_BITS; ++q) off[q] = 1LL << ps.owned[w + q];
  const long long sflat = base + deposit(ps, local_base(w));
#pragma unroll
  for (int r = 0; r < E; ++r) {
    long long f = sflat;
#pragma unroll
    for (int q = 0; q < REG_BITS; ++q)
      if ((r >> q) & 1) f += off[q];
    if (f < total) {
      keys[f] = k[r];
      payload[f] = p[r];
    }
  }
  // the next pass may launch: its CTAs wait above for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");
}

// A launch that may begin before the kernel ahead of it on the stream has
// finished (Hopper's programmatic dependent launch); the kernel waits for
// that kernel's writes itself (griddepcontrol.wait).
template <typename... Params, typename... Args>
static cudaError_t launch_dependent(void (*kernel)(Params...), unsigned blocks,
                                    size_t smem, cudaStream_t stream,
                                    Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

template <typename T>
static int run(const T* keys_in, long long key_stride, const int32_t* pay_in,
               long long pay_stride, T* keys, int32_t* payload,
               long long rows, long long n, int log_m, const uint32_t* plan,
               cudaStream_t stream) {
  const size_t smem = 2 * PADDED * sizeof(uint2);
  cudaError_t err;
  // the shared-memory limit, once per device and key type
  static std::atomic<unsigned long long> configured{0};
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ULL << (device & 63);
  if (!(configured.load() & bit)) {
    const void* kernels[] = {(const void*)bitonic_pass_kernel<T, true, true>,
                             (const void*)bitonic_pass_kernel<T, true, false>,
                             (const void*)bitonic_pass_kernel<T, false, false>};
    for (const void* fn : kernels)
      if ((err = cudaFuncSetAttribute(
               fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
        return (int)err;
    configured.fetch_or(bit);
  }
  const long long total = rows << log_m;
  const long long blocks = (total + CHUNK - 1) / CHUNK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_passes = (int)plan[0];
  const uint32_t* q = plan + 1;
  for (int i = 0; i < n_passes; ++i) {
    Pass ps;
    ps.owned_mask = (unsigned long long)q[0] | ((unsigned long long)q[1] << 32);
    for (int b = 0; b < LOG_CHUNK; ++b) ps.owned[b] = (signed char)q[2 + b];
    const uint32_t w0 = q[2 + LOG_CHUNK], n_ops = q[3 + LOG_CHUNK];
    if (n_ops > MAX_OPS || w0 > LOG_CHUNK - REG_BITS)
      return (int)cudaErrorInvalidValue;
    ps.w0 = (signed char)w0;
    ps.n_ops = (short)n_ops;
    for (uint32_t j = 0; j < n_ops; ++j) ps.ops[j] = q[4 + LOG_CHUNK + j];
    q += 4 + LOG_CHUNK + n_ops;
    err = cudaSuccess;
    if (i == 0 && log_m > LOG_CHUNK)    // the first pass, compiled in
      bitonic_pass_kernel<T, true, true><<<(unsigned)blocks, THREADS, smem,
                                           stream>>>(
          keys_in, key_stride, pay_in, pay_stride, keys, payload, rows, n,
          log_m, ps);
    else if (i == 0)
      bitonic_pass_kernel<T, true, false><<<(unsigned)blocks, THREADS, smem,
                                            stream>>>(
          keys_in, key_stride, pay_in, pay_stride, keys, payload, rows, n,
          log_m, ps);
    else
      err = launch_dependent(bitonic_pass_kernel<T, false, false>,
                             (unsigned)blocks, smem, stream,
                             static_cast<const T*>(keys), 0LL,
                             static_cast<const int32_t*>(nullptr), 0LL, keys,
                             payload, rows, n, log_m, ps);
    if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess)
      return (int)err;
  }
  return 0;
}

// keys_in (rows, n) with row stride key_stride, payload (rows, n) int32 with
// row stride pay_stride or null (arange(n)); sorted into keys_out and
// payload_out, (rows, 2^log_m) contiguous, the pad included.  dtype 0 =
// int32 keys, 1 = float32.  plan: ops.py::_plan_array(log_m).
extern "C" int bitonic_sort_launch(const void* keys_in, long long key_stride,
                                   const int32_t* pay_in, long long pay_stride,
                                   void* keys_out, int32_t* payload_out,
                                   long long rows, long long n, int log_m,
                                   int dtype, const uint32_t* plan,
                                   cudaStream_t stream) {
  if (rows <= 0 || log_m < 1 || log_m > 30 || n < 1 || n > (1LL << log_m) ||
      (dtype != 0 && dtype != 1) || plan == nullptr || plan[0] < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run(static_cast<const int32_t*>(keys_in), key_stride, pay_in,
               pay_stride, static_cast<int32_t*>(keys_out), payload_out,
               rows, n, log_m, plan, stream);
  return run(static_cast<const float*>(keys_in), key_stride, pay_in,
             pay_stride, static_cast<float*>(keys_out), payload_out, rows, n,
             log_m, plan, stream);
}
