// BabyBear NTT for Hopper (sm_90a): kernel B5, forward DIF and inverse DIT,
// and the forward transform with the LDE's coset scaling and zero-pad done
// on load.
//
// Replaces raiko_tpu/ops/ntt_pallas.py: ntt_fused and intt_fused (the
// fused four-step kernel _fourstep_fused), and covers every size the
// reference's ops/ntt.py covers (2 <= N <= 2^24 here), not only
// 2^14..2^20.
//
// Layout: (batch, N) u32 Montgomery rows, contiguous.  The forward
// transform takes natural order to bit-reversed order; the inverse takes
// bit-reversed order to natural order and scales by 1/N.  Outputs equal
// raiko_tpu/ops/ntt.py ntt / intt bit for bit: field arithmetic is exact and
// every value canonical, so any correct evaluation order agrees.  With the
// coset prologue the input is (batch, n) coefficients, n = N / 2^blowup:
// element i < n is read times shift^i (a table), the rest read as zero, so
// the call computes ntt(coset_pad(coeffs)) without the padded copy, as the
// JAX package's lde_from_coeffs does in one jit.
//
// What bounds it on the card, and the design:
// * A transform moves each element in and out once (8 bytes; with the
//   prologue at blowup 4, 4 bytes in for 16 out) and does log2(N)/2 Montgomery products per
//   element (4 32-bit multiplies each), so at the STARK commitment's sizes
//   (N = 1,024 and 4,096, batch 4,160) it is bound by device-memory bytes.
//   In practice the integer pipes come close first: a butterfly is 3
//   multiply-adds and 6-8 adds, compares and minimums (every value kept
//   canonical), 12 butterfly stages of 2,048 per row, so the kernel has to
//   spend few instructions per element beside them and keep enough loads
//   in flight.
// * A register radix.  Each thread holds 2^E elements of a row (E = 4 at
//   N = 4,096, 5 at 1,024) and runs E butterfly stages on them in
//   registers; between such passes the row goes once through shared memory.
//   N = 4,096 is 3 passes and 2 exchanges, N = 1,024 2 passes and 1.  In
//   pass p over stages s..s+k-1 an element's index splits into
//   hi (s bits) | mid (k bits) | low; a thread owns every mid of one
//   (hi, low), so the first forward pass reads and the last writes whole
//   warps of consecutive words, and the last forward pass (first inverse
//   one) owns 2^E consecutive words: 16-byte loads and stores.  Every load
//   of a thread is issued before its first butterfly.
// * The exchange layout is word q ^ ((q >> E) & 31): with k = E every pass
//   reads and writes a warp's 32 words in 32 different banks (checked by a
//   model of the index maps for every size; N = 128 and 2,048, which have a
//   shorter pass, keep 2-way conflicts).  Two buffers alternate, so an
//   exchange costs one barrier.
// * The DIF difference u - v + p (< 2p < 2^32) goes into its product
//   unreduced; the product reduces.  No other value may stay unreduced: a
//   sum of two values below 2p can pass 2^32.
// * Registers: the row kernel asks for 4 resident blocks a SM (at most 64
//   registers at 256 threads).  Without it ptxas gave the prologue kernel
//   148 registers and 2 blocks a SM, and the LDE ran 31% slower.
// * Twiddles: one table per stage (w_N^(j·2^s), j < N/2^(s+1), the
//   reference's per-stage tables end to end, N - 1 words), staged in shared
//   memory once per block; a warp reads consecutive or equal words.  A
//   block loops over rows (a grid of at most one wave), so the table is
//   read once per resident block, not once per row.  In the pass that ends
//   at the last stage a twiddle's index depends on the register alone: a
//   warp reads one word, and the products by w^0 = 1 (8 + 4 + 2 + 1 of a
//   thread's 32 there) are left out.
// * N > 4,096: the four-step split of the Pallas kernel, N = R x C with
//   R = 2^(log N / 2): a column pass (the length-R transforms down the
//   columns of the row viewed as R x C, a tile of columns per block, the
//   same register radix with a column per lane group, then the cross
//   twiddles) and a row pass (the length-C transforms along the rows, by the
//   small-N kernel).  The Pallas kernel's transposes become the column
//   tile's strided loads.  The inverse runs the two passes in the mirror
//   order.
// The Pallas kernel's TPU layout (butterflies along sublanes, twiddles
// packed column-wise for (half, 1) sublane reads) does not carry over.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (the card's time per call,
// chip_smoke.py; PERF.md): ntt at 4,160 x 4,096 0.088 ms against a byte
// bound of 0.041; intt at 4,160 x 1,024 0.019 against 0.010; the
// prologue's 4,160 x 1,024 -> 4,096 0.094 ms against 0.025.  ptxas
// (sm_90a, -O3), no spills: the row kernel at 4,096 61 registers (56 with
// the prologue, 64 inverse), at 1,024 128; the column kernels 32-80.

#include <cuda_runtime.h>

#include "babybear.cuh"

namespace raiko {
namespace {

constexpr int kRowMaxLog = 12;     // whole rows in one block up to 2^12
constexpr int kRowElems = 4096;    // a row kernel block's elements
constexpr int kColElems = 8192;    // a column kernel block's elements
constexpr int kMaxThreads = 256;   // row kernel
constexpr int kMaxColThreads = 512;
constexpr int kRowMinBlocks = 4;   // row kernel blocks resident a SM (64 registers)

// log2 of the elements a thread holds, by log2 of the transform's length:
// every pass then runs E stages (the model's conflict-free case) except
// at 7 and 11, where one pass runs fewer
__host__ __device__ constexpr int radix_log(int L) {
  return L <= 5 ? L : L == 6 || L == 9 ? 3 : L == 10 ? 5 : 4;
}

// The passes of a length-2^L transform on threads holding 2^E elements:
// ceil(L / E) passes of E stages, the shortfall taken off the middle pass
// (or off the last when there are two).
template <int L>
struct Plan {
  static constexpr int E = radix_log(L);
  static constexpr int kPasses = (L + E - 1) / E;
  static constexpr int kShort = kPasses > 2 ? 1 : kPasses - 1;
  __host__ __device__ static constexpr int k(int p) {
    return E - (p == kShort ? kPasses * E - L : 0);
  }
  __host__ __device__ static constexpr int s(int p) { return p == 0 ? 0 : s(p - 1) + k(p - 1); }
};

// The index in the row of a thread's element j in a pass over stages
// S..S+K-1: j = (x, mid), the thread's g and x form (hi, low).
template <int L, int E, int S, int K>
__device__ __forceinline__ uint32_t elem(uint32_t g, int j) {
  constexpr int B = L - S - K;
  const uint32_t x = (uint32_t)j >> K, mid = (uint32_t)j & ((1u << K) - 1);
  const uint32_t o = (x << (L - E)) | g;
  return ((o >> B) << (K + B)) | (mid << B) | (o & ((1u << B) - 1));
}

// The butterflies of one pass on a thread's registers.  Forward: DIF
// stages S..S+K-1 in order; inverse: DIT stages in reverse order, with the
// inverse tables.  tw: the per-stage tables, stage st from N - (N >> st).
template <int L, int E, int S, int K, bool kInv>
__device__ __forceinline__ void butterflies(uint32_t (&v)[1 << E], uint32_t g,
                                            const uint32_t* tw) {
  constexpr int N = 1 << L;
  constexpr int B = L - S - K;
#pragma unroll
  for (int tt = 0; tt < K; ++tt) {
    const int t = kInv ? K - 1 - tt : tt;
    const int st = S + t;
    const int hb = K - 1 - t;  // the mid bit this stage pairs
    const uint32_t* tws = tw + (N - (N >> st));
#pragma unroll
    for (int j0 = 0; j0 < (1 << E); ++j0) {
      if (j0 & (1 << hb)) continue;
      const int j1 = j0 | (1 << hb);
      const uint32_t x = (uint32_t)j0 >> K, mid = (uint32_t)j0 & ((1u << K) - 1);
      // in a pass that ends at the last stage (B = 0) the index is known
      // here, and the twiddles of index 0 are 1
      const bool unit = B == 0 && (mid & ((1u << hb) - 1)) == 0;
      uint32_t w = 0;
      if (!unit) {
        const uint32_t o = (x << (L - E)) | g;
        w = tws[((mid & ((1u << hb) - 1)) << B) | (o & ((1u << B) - 1))];
      }
      const uint32_t u = v[j0];
      if (kInv) {
        const uint32_t y = unit ? v[j1] : bb::mul(v[j1], w);
        v[j0] = bb::add(u, y);
        v[j1] = bb::sub(u, y);
      } else {
        const uint32_t y = v[j1];
        v[j0] = bb::add(u, y);
        // u - y + p < 2p < 2^32 goes into the product unreduced
        v[j1] = unit ? bb::sub(u, y) : bb::mul(u - y + bb::P, w);
      }
    }
  }
}

template <int E>
__device__ __forceinline__ uint32_t swizzle(uint32_t q) {
  return q ^ ((q >> E) & 31u);
}

// Hand a thread's elements from the mapping of pass (SW, KW) to that of
// pass (SR, KR) through shared memory: element i of this thread's row or
// column sits at word i * kStride + add.
template <int L, int E, int SW, int KW, int SR, int KR, int kStride>
__device__ __forceinline__ void exchange(uint32_t (&v)[1 << E], uint32_t g, uint32_t* sm,
                                         uint32_t add) {
#pragma unroll
  for (int j = 0; j < (1 << E); ++j) sm[swizzle<E>(elem<L, E, SW, KW>(g, j) * kStride + add)] = v[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < (1 << E); ++j) v[j] = sm[swizzle<E>(elem<L, E, SR, KR>(g, j) * kStride + add)];
}

// Pass P's butterflies, then the exchange into the next pass and the rest
// (forward: P + 1 ...; inverse: P - 1 ... 0).  Exchanges alternate between
// two buffers of `buf_words`, so a buffer is rewritten only after the
// barrier of the exchange between.
template <int L, bool kInv, int P, int kStride>
__device__ __forceinline__ void run_passes(uint32_t (&v)[1 << Plan<L>::E], uint32_t g,
                                           const uint32_t* tw, uint32_t* xb, int buf_words,
                                           int& buf, uint32_t add) {
  using Pl = Plan<L>;
  butterflies<L, Pl::E, Pl::s(P), Pl::k(P), kInv>(v, g, tw);
  constexpr int Q = kInv ? P - 1 : P + 1;
  if constexpr (Q >= 0 && Q < Pl::kPasses) {
    exchange<L, Pl::E, Pl::s(P), Pl::k(P), Pl::s(Q), Pl::k(Q), kStride>(v, g, xb + buf * buf_words,
                                                                         add);
    buf ^= 1;
    run_passes<L, kInv, Q, kStride>(v, g, tw, xb, buf_words, buf, add);
  }
}

// A pass whose elements are groups of 2^K consecutive words (B = 0: the
// last forward pass, the first inverse one): 16-byte loads and stores.
template <int L, int P>
__device__ __forceinline__ void load_groups(uint32_t (&v)[1 << Plan<L>::E], const uint32_t* src,
                                            uint32_t g) {
  using Pl = Plan<L>;
  constexpr int S = Pl::s(P), K = Pl::k(P);
  static_assert(S + K == L, "a pass of consecutive words");
  if constexpr (K >= 2) {
#pragma unroll
    for (int j = 0; j < (1 << Pl::E); j += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(src + elem<L, Pl::E, S, K>(g, j));
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < (1 << Pl::E); ++j) v[j] = src[elem<L, Pl::E, S, K>(g, j)];
  }
}

template <int L, int P>
__device__ __forceinline__ void store_groups(const uint32_t (&v)[1 << Plan<L>::E], uint32_t* dst,
                                             uint32_t g) {
  using Pl = Plan<L>;
  constexpr int S = Pl::s(P), K = Pl::k(P);
  static_assert(S + K == L, "a pass of consecutive words");
  if constexpr (K >= 2) {
#pragma unroll
    for (int j = 0; j < (1 << Pl::E); j += 4)
      *reinterpret_cast<uint4*>(dst + elem<L, Pl::E, S, K>(g, j)) =
          make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < (1 << Pl::E); ++j) dst[elem<L, Pl::E, S, K>(g, j)] = v[j];
  }
}

__device__ __forceinline__ void stage_table(uint32_t* tw, const uint32_t* __restrict__ tw_g, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) tw[i] = __ldg(tw_g + i);
  __syncthreads();
}

template <int L>
struct RowShape {
  static constexpr int E = Plan<L>::E;
  static constexpr int kThreads = (kRowElems >> E) < kMaxThreads ? (kRowElems >> E) : kMaxThreads;
  static constexpr int kPerRow = 1 << (L - E);          // threads per row
  static constexpr int kRows = kThreads / kPerRow;      // rows per block
  static constexpr int kBufWords = kRows << L;
  static constexpr size_t kSmem = ((1 << L) + (Plan<L>::kPasses > 1 ? 2 * kBufWords : 0)) * 4;
  static_assert(kPerRow <= kThreads, "a row fits one block");
};

// Whole rows of 2^L elements, RowShape::kRows rows per block at a time, the
// grid looping over rows.  `scale` (Montgomery), when nonzero, multiplies
// every inverse output.  With kCoset the input rows are 2^log_in long
// (log_in <= L) and element i reads x[i] * coset[i] for i < 2^log_in, zero
// above.  `x` may equal `out`: a block reads its rows completely before it
// writes them.
template <int L, bool kInv, bool kCoset>
__global__ void __launch_bounds__(RowShape<L>::kThreads, kRowMinBlocks) ntt_rows_kernel(
    const uint32_t* x, uint32_t* out, const uint32_t* __restrict__ tw_g, long long rows,
    uint32_t scale, const uint32_t* __restrict__ coset, int log_in) {
  using Pl = Plan<L>;
  using Sh = RowShape<L>;
  constexpr int E = Pl::E, N = 1 << L;
  extern __shared__ uint32_t smem[];
  uint32_t* tw = smem;
  uint32_t* xb = smem + N;
  stage_table(tw, tw_g, N - 1);
  const int r = threadIdx.x / Sh::kPerRow;
  const uint32_t g = threadIdx.x % Sh::kPerRow;
  const uint32_t add = (uint32_t)r << L;
  int buf = 0;
  for (long long row0 = (long long)blockIdx.x * Sh::kRows; row0 < rows;
       row0 += (long long)gridDim.x * Sh::kRows) {
    const long long row = row0 + r;
    const bool live = row < rows;
    uint32_t v[1 << E];
    if constexpr (kInv) {
      constexpr int First = Pl::kPasses - 1;
      if (live) {
        load_groups<L, First>(v, x + (size_t)row * N, g);
      } else {
#pragma unroll
        for (int j = 0; j < (1 << E); ++j) v[j] = 0;
      }
      run_passes<L, true, First, 1>(v, g, tw, xb, Sh::kBufWords, buf, add);
      if (live) {
        uint32_t* dst = out + (size_t)row * N;
#pragma unroll
        for (int j = 0; j < (1 << E); ++j)
          dst[elem<L, E, 0, Pl::k(0)>(g, j)] = scale ? bb::mul(v[j], scale) : v[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < (1 << E); ++j) {
        const uint32_t i = elem<L, E, 0, Pl::k(0)>(g, j);
        if (kCoset) {
          v[j] = live && i < (1u << log_in)
                     ? bb::mul(x[((size_t)row << log_in) + i], __ldg(coset + i))
                     : 0u;
        } else {
          v[j] = live ? x[(size_t)row * N + i] : 0u;
        }
      }
      run_passes<L, false, 0, 1>(v, g, tw, xb, Sh::kBufWords, buf, add);
      if (live) store_groups<L, Pl::kPasses - 1>(v, out + (size_t)row * N, g);
    }
  }
}

template <int LR>
struct ColShape {
  static constexpr int E = Plan<LR>::E;
  static constexpr int kThreads =
      (kColElems >> E) < kMaxColThreads ? (kColElems >> E) : kMaxColThreads;
  static constexpr int kPerCol = 1 << (LR - E);
  static constexpr int kCols = kThreads / kPerCol;  // columns of a tile
  static constexpr int kColsLog = kCols == 1 ? 0 : kCols == 2 ? 1 : kCols == 4 ? 2 : kCols == 8 ? 3
                                  : kCols == 16 ? 4 : kCols == 32 ? 5 : kCols == 64 ? 6 : 7;
  static constexpr int kBufWords = kCols << LR;
  static constexpr size_t kSmem = ((1 << LR) + (Plan<LR>::kPasses > 1 ? 2 * kBufWords : 0)) * 4;
  static_assert(kCols >= 1, "a column fits one block");
};

// The four-step column pass over rows viewed as (R, C) = (2^LR, 2^log_c):
// block (b, tile) holds columns [c0, c0 + kCols) of row b, element r of a
// column at word r * kCols + column of the exchange buffers.  Forward: DIF
// down each column, then times cross[r][c]; with kCoset the row's input
// is 2^log_in long and scaled by coset[i] on load, as in ntt_rows_kernel.
// Inverse: times cross[r][c] (the inverse table), DIT down each column,
// then times `scale`.  In place is safe: a block reads its tile before it
// writes it.
template <int LR, bool kInv, bool kCoset>
__global__ void __launch_bounds__(ColShape<LR>::kThreads) ntt_cols_kernel(
    const uint32_t* x, uint32_t* out, const uint32_t* __restrict__ tw_g,
    const uint32_t* __restrict__ cross, int log_c, uint32_t scale,
    const uint32_t* __restrict__ coset, int log_in) {
  using Pl = Plan<LR>;
  using Sh = ColShape<LR>;
  constexpr int E = Pl::E;
  extern __shared__ uint32_t smem[];
  uint32_t* tw = smem;
  uint32_t* xb = smem + (1 << LR);
  stage_table(tw, tw_g, (1 << LR) - 1);
  const int tiles_log = log_c - Sh::kColsLog;
  const long long b = blockIdx.x >> tiles_log;
  const uint32_t c = threadIdx.x % Sh::kCols;
  const uint32_t g = threadIdx.x / Sh::kCols;
  const uint32_t col = ((blockIdx.x & ((1u << tiles_log) - 1)) * Sh::kCols) + c;
  const size_t base = (size_t)b << (LR + log_c);
  uint32_t v[1 << E];
  int buf = 0;
  constexpr int First = kInv ? Pl::kPasses - 1 : 0;
  constexpr int Last = kInv ? 0 : Pl::kPasses - 1;
#pragma unroll
  for (int j = 0; j < (1 << E); ++j) {
    const uint32_t gi = (elem<LR, E, Pl::s(First), Pl::k(First)>(g, j) << log_c) | col;
    if (kInv) {
      v[j] = bb::mul(x[base + gi], __ldg(cross + gi));
    } else if (kCoset) {
      v[j] = gi < (1u << log_in) ? bb::mul(x[((size_t)b << log_in) + gi], __ldg(coset + gi)) : 0u;
    } else {
      v[j] = x[base + gi];
    }
  }
  run_passes<LR, kInv, First, Sh::kCols>(v, g, tw, xb, Sh::kBufWords, buf, c);
#pragma unroll
  for (int j = 0; j < (1 << E); ++j) {
    const uint32_t gi = (elem<LR, E, Pl::s(Last), Pl::k(Last)>(g, j) << log_c) | col;
    out[base + gi] = kInv ? (scale ? bb::mul(v[j], scale) : v[j]) : bb::mul(v[j], __ldg(cross + gi));
  }
}

// Allow a kernel more than 48 KB of dynamic shared memory where it needs it.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return smem > 48 * 1024
             ? (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
             : 0;
}

// The grid of a kernel that loops over its work: at most the blocks that
// fit on the card at once.
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem) {
  allow_smem(kernel, smem);
  int per_sm = 0, dev = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return per_sm > 0 ? per_sm * sms : 1;
}

template <int L, bool kInv, bool kCoset>
void launch_rows_t(const uint32_t* x, uint32_t* out, const uint32_t* tw, long long rows,
                   uint32_t scale, const uint32_t* coset, int log_in, cudaStream_t st) {
  using Sh = RowShape<L>;
  const auto kernel = ntt_rows_kernel<L, kInv, kCoset>;
  static const int max_blocks = resident_blocks(kernel, Sh::kThreads, Sh::kSmem);
  const long long need = (rows + Sh::kRows - 1) / Sh::kRows;
  const unsigned blocks = (unsigned)(need < max_blocks ? need : max_blocks);
  kernel<<<blocks, Sh::kThreads, Sh::kSmem, st>>>(x, out, tw, rows, scale, coset, log_in);
}

template <int LR, bool kInv, bool kCoset>
void launch_cols_t(const uint32_t* x, uint32_t* out, const uint32_t* tw, const uint32_t* cross,
                   long long batch, int log_c, uint32_t scale, const uint32_t* coset, int log_in,
                   cudaStream_t st) {
  using Sh = ColShape<LR>;
  const auto kernel = ntt_cols_kernel<LR, kInv, kCoset>;
  static const int allowed = allow_smem(kernel, Sh::kSmem);
  (void)allowed;
  const long long blocks = batch * ((1LL << log_c) / Sh::kCols);
  kernel<<<(unsigned)blocks, Sh::kThreads, Sh::kSmem, st>>>(x, out, tw, cross, log_c, scale, coset,
                                                           log_in);
}

#define RAIKO_ROWS_CASE(L) \
  case L:                  \
    launch_rows_t<L, kInv, kCoset>(x, out, tw, rows, scale, coset, log_in, st); \
    return 0;

template <bool kInv, bool kCoset>
int launch_rows(const uint32_t* x, uint32_t* out, const uint32_t* tw, long long rows, int log_n,
                uint32_t scale, const uint32_t* coset, int log_in, cudaStream_t st) {
  switch (log_n) {
    RAIKO_ROWS_CASE(1) RAIKO_ROWS_CASE(2) RAIKO_ROWS_CASE(3) RAIKO_ROWS_CASE(4)
    RAIKO_ROWS_CASE(5) RAIKO_ROWS_CASE(6) RAIKO_ROWS_CASE(7) RAIKO_ROWS_CASE(8)
    RAIKO_ROWS_CASE(9) RAIKO_ROWS_CASE(10) RAIKO_ROWS_CASE(11) RAIKO_ROWS_CASE(12)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#define RAIKO_COLS_CASE(LR) \
  case LR:                  \
    launch_cols_t<LR, kInv, kCoset>(x, out, tw, cross, batch, log_c, scale, coset, log_in, st); \
    return 0;

template <bool kInv, bool kCoset>
int launch_cols(const uint32_t* x, uint32_t* out, const uint32_t* tw, const uint32_t* cross,
                long long batch, int log_r, int log_c, uint32_t scale, const uint32_t* coset,
                int log_in, cudaStream_t st) {
  switch (log_r) {
    RAIKO_COLS_CASE(6) RAIKO_COLS_CASE(7) RAIKO_COLS_CASE(8) RAIKO_COLS_CASE(9)
    RAIKO_COLS_CASE(10) RAIKO_COLS_CASE(11) RAIKO_COLS_CASE(12)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace raiko

// One B5 transform of `batch` rows of 2^log_n elements, x -> out.
// log_r == 0: one pass (log_n <= 12), tw_rows = the per-stage tables of
// w_N.  log_r > 0: the four-step split with R = 2^log_r (6..12),
// C = 2^(log_n - log_r) <= 2^12, tw_rows = the per-stage tables of w_C,
// tw_cols those of w_R, cross = the (R, C) cross twiddles.  All tables
// Montgomery, inverse roots for the inverse.  ninv = Montgomery 1/N,
// applied by the inverse only.  coset (forward only), when not null: x
// holds rows of 2^log_in <= 2^log_n coefficients, element i read times
// coset[i] and zero from 2^log_in on; otherwise log_in is log_n.
extern "C" int raiko_babybear_ntt(const void* x, void* out, const void* tw_rows,
                                  const void* tw_cols, const void* cross, long long batch,
                                  int log_n, int log_r, int inverse, unsigned ninv,
                                  const void* coset, int log_in, void* stream) {
  using namespace raiko;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* xi = (const uint32_t*)x;
  uint32_t* o = (uint32_t*)out;
  const uint32_t* twr = (const uint32_t*)tw_rows;
  const uint32_t* twc = (const uint32_t*)tw_cols;
  const uint32_t* cr = (const uint32_t*)cross;
  const uint32_t* cs = (const uint32_t*)coset;
  if (batch <= 0) return (int)cudaGetLastError();
  if ((inverse && cs) || log_in > log_n || (!cs && log_in != log_n)) return (int)cudaErrorInvalidValue;
  int err;
  if (log_r == 0) {
    if (log_n > kRowMaxLog) return (int)cudaErrorInvalidValue;
    if (inverse) {
      err = launch_rows<true, false>(xi, o, twr, batch, log_n, ninv, nullptr, log_n, st);
    } else if (cs) {
      err = launch_rows<false, true>(xi, o, twr, batch, log_n, 0u, cs, log_in, st);
    } else {
      err = launch_rows<false, false>(xi, o, twr, batch, log_n, 0u, nullptr, log_n, st);
    }
    return err ? err : (int)cudaGetLastError();
  }
  const int log_c = log_n - log_r;
  if (log_c > kRowMaxLog || log_c < log_r) return (int)cudaErrorInvalidValue;
  if (inverse) {
    err = launch_rows<true, false>(xi, o, twr, batch << log_r, log_c, 0u, nullptr, log_c, st);
    if (err || (err = (int)cudaGetLastError())) return err;
    err = launch_cols<true, false>(o, o, twc, cr, batch, log_r, log_c, ninv, nullptr, log_n, st);
  } else {
    err = cs ? launch_cols<false, true>(xi, o, twc, cr, batch, log_r, log_c, 0u, cs, log_in, st)
             : launch_cols<false, false>(xi, o, twc, cr, batch, log_r, log_c, 0u, nullptr, log_n, st);
    if (err || (err = (int)cudaGetLastError())) return err;
    err = launch_rows<false, false>(o, o, twr, batch << log_r, log_c, 0u, nullptr, log_c, st);
  }
  return err ? err : (int)cudaGetLastError();
}
