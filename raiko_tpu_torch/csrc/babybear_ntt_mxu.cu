// BabyBear NTT by exact int8 digit products on Hopper's tensor cores
// (sm_90a): kernel B6.
//
// Replaces raiko_tpu/ops/ntt_mxu.py: ntt_mxu_pallas (kernel _mxu_dft_pallas),
// and computes what raiko_tpu/ops/ntt_mxu.py:ntt_mxu computes: the forward
// NTT of (batch, N) u32 Montgomery rows, N = R x C with R = 2^(log N / 2)
// and R, C <= 128, natural order in, bit-reversed order out, bit for bit the
// result of raiko_tpu/ops/ntt.py:ntt.
//
// The transform is two DFT passes over each row viewed as (R, C):
//   pass 1: a[k, c] = (sum_j W_R[k, j] x[j, c]) * cross[k, c]  (down columns)
//   pass 2: y[r, k] =  sum_j W_C[k, j] a[r, j]                  (along rows)
// where W_M[k, j] = w_M^(brp(k) j) in standard form.  Each dot product runs
// exactly over the integers: x and W are cut into four balanced signed
// 8-bit digits (x = sum_l 2^(8l) x_l, x_l in [-128, 128)), and the seven
// diagonal sums S_s = sum_{i+l=s} W_i . x_l (|S_s| <= 4 * 128 * 128 * 128 =
// 2^23, exact in int32) give the output as sum_s S_s 2^(8s) mod p.
//
// What bounds it on the card, and the design:
// * Per row the work is 16 N (R + C) int8 multiply-adds against 8 bytes per
//   element moved.  At 4,160 x 4,096 that is 34.9 G MACs, 0.035 ms at the
//   dense int8 tensor-core rate, against 136 MB, 0.041 ms at 3.35 TB/s: the
//   bytes bound it, just, and only if the products run on the tensor cores
//   and each element crosses device memory once.  At 64 x 2^14 the MACs
//   bound it (4.3 G, 0.0043 ms).  mma.sync reaches 0.59 m16n8k32 a clock
//   per SM on an H100 80GB HBM3 at 700 W (tools/profile_b6.py), 64% of the
//   int8 rate, so the products alone need 0.055 ms there.
// * The digit products are mma.sync.m16n8k32 s8 x s8 -> s32 (IMMA).  The A
//   operand is W_i (rows k, columns j), the B operand x_l (rows j, columns
//   = the lanes of the pass), so one instruction is 16 outputs x 8 lanes x
//   32 j of one digit pair.  The 16 pairs of a 16 x 8 output tile sum into
//   seven int32 accumulators, one per diagonal s = i + l: a tile holds
//   S_0..S_6 of its 128 outputs, 28 registers a thread.
// * W is constant: the host packs each W_i as the A fragments themselves
//   (ops/ntt_mxu_cuda.py:_packed_matrix): int32 word
//   [kb][kc][i][lane][r], lane = 4g + t, holds the bytes
//   W_i[16 kb + g + 8 (r & 1)][32 kc + 16 (r >> 1) + 4 t + b], b = 0..3,
//   zero outside M x M.  A warp owns one k-block kb, loads its 16 KC words
//   a thread once (one coalesced 16-byte load each) and keeps them in
//   registers while it walks the lanes.
// * The digits of a value v < p are the bytes of (v + 0x80808080) ^
//   0x80808080 (balanced digits are unique, so these are the reference's),
//   and four values j .. j + 3 of one lane, byte-transposed by
//   __byte_perm, give four words, word l the digit-l bytes: one B-fragment
//   register.  The B operand of (digit l, K-chunk kc, lane, t) is the
//   register pair for j = 32 kc + 4 t and j + 16, so the digits lie in
//   shared memory as int4 (lane, kc, t, h) = those pairs of digits 2h and
//   2h + 1, at ((lane KC + kc) 8 + ((2t + h) ^ ((lane + kc) & 7))): a
//   16-byte load yields two operand pairs in consecutive registers (no
//   moves before the IMMA), and the fragment loads (two lanes x four t a
//   quarter warp), the pass-1 conversion's stores (eight lanes) and the
//   pass-2 conversion's (four t x two kc) each hit eight different 16-byte
//   bank groups.
// * Recombination: per output and pass, V = p 2^26 + sum_s S_s b_s with
//   b_s = 2^(8s) 2^32 mod p is positive and below p 2^32 (|sum| < 7 2^54),
//   so one Montgomery step gives V 2^-32 = sum_s S_s 2^(8s) mod p: seven
//   32 x 32 -> 64-bit multiply-adds and one reduction instead of seven
//   Montgomery products.  The cross twiddle after pass 1 is one Montgomery
//   product.
// * Routes.  N <= 2^12: one block of 4 warps runs a whole row, both passes
//   (mxu_row_kernel); the row crosses device memory once, in and out, and
//   the pass-1 results stay in shared memory ([k][c], 8 = 32 words of
//   padding a row, so the tile's 8-byte stores are conflict-free).  At
//   2^12 that is 35 KB of shared memory and 80 registers, six blocks an SM.
//   N = 2^13 and 2^14 take two launches over tiles of 32 lanes
//   (mxu_tile_kernel; pass 1: 32 columns of a row, pass 2: 32 rows),
//   through a scratch buffer: a row of 2^14 would need 192 KB and leave
//   most SMs idle at the batches these sizes come in (64 x 2^14 is 64
//   rows); the 8 MB between the passes stays in the 50 MB L2.  Below 32 the
//   K dimension (M) pads with zero columns of W, and below 16 (rows) and 8
//   (lanes) the tile pads too; every size 1 to 2^14 runs the tensor cores.
//   ptxas (nvcc 12.9, sm_90a, -O3): the row kernels 60-80 registers, the
//   tile kernels 82-128, no spills.
// * Measured (H100 80GB HBM3, 700 W, CUDA graphs; PERF.md): 0.169-0.172 ms
//   at 4,160 x 4,096 (the __dp4a kernel before it 0.944, B5 0.088) and
//   0.0189-0.0192 ms at 64 x 2^14 (0.129; B5 0.0116).  What holds it at
//   4,160 x 4,096 (tools/profile_b6.py): the products alone take 0.078 ms,
//   0.42 m16n8k32 a clock per SM against mma.sync's 0.59; the
//   recombination and stores add 0.072 ms that the products do not hide;
//   loads and digit conversion alone take 0.030.
//   Tried in copies of this source and not kept, none faster: blocks that
//   stay resident and copy the next row in by cp.async, 8 warps a row
//   block, the products issued by diagonal, the next tile's products in
//   flight while one recombines, accumulators split by K-chunk, and a
//   recombination by shifts, adds and three 64-bit products (fewer
//   multiplies, more instructions: slower, so issue, not the multiplier,
//   holds the epilogue).

#include <cuda_runtime.h>

#include <algorithm>

#include "babybear.cuh"

// Parts of the kernel taken out, for tools/profile_b6.py, which builds
// copies with RAIKO_MXU_PROFILE set (they compute garbage): 1, no
// recombination or stores (the products must still finish); 2, that and no
// loads or digit conversion; 3, no DFT passes (loads, conversion, barriers
// only).  0, the kernel, in the library.
#ifndef RAIKO_MXU_PROFILE
#define RAIKO_MXU_PROFILE 0
#endif

namespace raiko {
namespace {

constexpr int kProfile = RAIKO_MXU_PROFILE;

constexpr int kRowThreads = 128;   // a block of the one-launch route: 4 warps
constexpr int kTileThreads = 256;  // a block of the two-launch route: 8 warps
constexpr int kLogTileLanes = 5, kTileLanes = 1 << kLogTileLanes;  // lanes per block, two-launch route
constexpr int kRowRouteMaxLogN = 12;

// 2^e mod p
__host__ __device__ constexpr uint32_t pow2_mod(int e) {
  uint64_t r = 1;
  for (int i = 0; i < e; ++i) r = r * 2 % bb::P;
  return (uint32_t)r;
}
// b_s = 2^(8s) 2^32 mod p, and the lift p 2^26 = 0 mod p that makes V positive
constexpr int64_t kB0 = pow2_mod(32), kB1 = pow2_mod(40), kB2 = pow2_mod(48), kB3 = pow2_mod(56),
                  kB4 = pow2_mod(64), kB5 = pow2_mod(72), kB6 = pow2_mod(80);
constexpr int64_t kLift = (int64_t)bb::P << 26;

// sum_s S_s 2^(8s) mod p, canonical, from accumulator r of the seven sums
__device__ __forceinline__ uint32_t recombine(const int (&s)[7][4], int r) {
  int64_t v = kLift + (int64_t)s[0][r] * kB0;
  v += (int64_t)s[1][r] * kB1;
  v += (int64_t)s[2][r] * kB2;
  v += (int64_t)s[3][r] * kB3;
  v += (int64_t)s[4][r] * kB4;
  v += (int64_t)s[5][r] * kB5;
  v += (int64_t)s[6][r] * kB6;
  const uint64_t t = (uint64_t)v;  // in (0, p 2^32)
  const uint32_t m = (uint32_t)t * bb::NPRIME;
  return bb::canon((uint32_t)(((uint64_t)m * bb::P + t) >> 32));
}

// the chunk of four values of one lane: word l holds digit l of each, byte q
// that of value q
__device__ __forceinline__ int4 digit_chunk(uint4 v) {
  const uint32_t w0 = (v.x + 0x80808080u) ^ 0x80808080u, w1 = (v.y + 0x80808080u) ^ 0x80808080u;
  const uint32_t w2 = (v.z + 0x80808080u) ^ 0x80808080u, w3 = (v.w + 0x80808080u) ^ 0x80808080u;
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
  return make_int4((int)__byte_perm(t0, t2, 0x5410), (int)__byte_perm(t0, t2, 0x7632),
                   (int)__byte_perm(t1, t3, 0x5410), (int)__byte_perm(t1, t3, 0x7632));
}

// int4 (lane, kc, t, h) of a pass's digits: the B fragments of digits 2h
// and 2h + 1 for lane, K-chunk kc and fragment row group t, as register
// pairs (see the header)
__device__ __forceinline__ int chunk_at(int lane, int kc, int t, int h, int log_kc) {
  return (((lane << log_kc) + kc) << 3) + ((2 * t + h) ^ ((lane + kc) & 7));
}

// d += A B for one m16n8k32 s8 tile
__device__ __forceinline__ void mma_s8(int (&d)[4], const int4& a, int b0, int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Write the digits of a pass over 2^log_lanes lanes (>= 8) and K = 32 KC:
// load(lane, j) gives the values j .. j + 3 of a lane.  An item (lane, kc,
// t) is 8 values, j = 32 kc + 4 t + 0..3 and 16 more, as two int4.
// Lane-major walks the lanes fastest (pass 1: neighbouring threads read
// neighbouring columns), else t and kc.
template <int kThreads, int KC, bool kLaneMajor, class Load>
__device__ __forceinline__ void fill_digits(int4* digits, int log_lanes, Load load) {
  constexpr int kLogKc = KC == 1 ? 0 : KC == 2 ? 1 : 2;
  if (kProfile == 2 && log_lanes >= 0) return;
  const int total = 4 * KC << log_lanes;
#pragma unroll 2
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int lane = kLaneMajor ? i & ((1 << log_lanes) - 1) : i >> (2 + kLogKc);
    const int kt = kLaneMajor ? i >> log_lanes : i & (4 * KC - 1);
    const int kc = kt >> 2, t = kt & 3;
    const int4 lo = digit_chunk(load(lane, 32 * kc + 4 * t)), hi = digit_chunk(load(lane, 32 * kc + 4 * t + 16));
    digits[chunk_at(lane, kc, t, 0, kLogKc)] = make_int4(lo.x, hi.x, lo.y, hi.y);
    digits[chunk_at(lane, kc, t, 1, kLogKc)] = make_int4(lo.z, hi.z, lo.w, hi.w);
  }
}

// The k-block a warp owns in a pass of M = m (warps beyond the k-blocks
// take the next n-tiles), and its A fragments.
__device__ __forceinline__ int pass_kb(int m) { return (threadIdx.x >> 5) % (m <= 16 ? 1 : m >> 4); }

template <int KC>
__device__ __forceinline__ void load_frags(int4 (&a)[KC][4], const int4* __restrict__ w, int kb) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kc][i] = __ldg(w + ((kb * KC + kc) * 4 + i) * 32 + (threadIdx.x & 31));
}

// One DFT pass over the digits with the warp's A fragments (load_frags at
// pass_kb(m)): outputs (k, lane) for k < 16 ceil(m / 16) and lane <
// lanes_p, handed to store(k, lane, v(k, lane), v(k, lane + 1)) (lane
// even), which drops those past the pass's m and lanes.
template <int kThreads, int KC, class Store>
__device__ __forceinline__ void dft_pass(const int4 (&a)[KC][4], const int4* digits, int m, int lanes_p,
                                         Store store) {
  constexpr int kLogKc = KC == 1 ? 0 : KC == 2 ? 1 : 2;
  if (kProfile == 3 && m >= 0) return;
  const int kbs = m <= 16 ? 1 : m >> 4;  // k-blocks, <= the block's warps
  const int nts = lanes_p >> 3;          // n-tiles of 8 lanes
  const int ln = threadIdx.x & 31, g = ln >> 2, t = ln & 3;
  const int k0 = pass_kb(m) * 16 + g;
  for (int nt = (threadIdx.x >> 5) / kbs; nt < nts; nt += (kThreads >> 5) / kbs) {
    const int lane = nt * 8 + g;
    int s[7][4];
#pragma unroll
    for (int q = 0; q < 7; ++q) s[q][0] = s[q][1] = s[q][2] = s[q][3] = 0;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int4 d01 = digits[chunk_at(lane, kc, t, 0, kLogKc)], d23 = digits[chunk_at(lane, kc, t, 1, kLogKc)];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mma_s8(s[i], a[kc][i], d01.x, d01.y);
        mma_s8(s[i + 1], a[kc][i], d01.z, d01.w);
        mma_s8(s[i + 2], a[kc][i], d23.x, d23.y);
        mma_s8(s[i + 3], a[kc][i], d23.z, d23.w);
      }
    }
    const int lane0 = nt * 8 + 2 * t;
    if constexpr (kProfile == 1 || kProfile == 2) {  // a store that never happens keeps the products
      const int x = s[0][0] ^ s[1][1] ^ s[2][2] ^ s[3][3] ^ s[4][0] ^ s[5][1] ^ s[6][2];
      if (x == 0x7654321) store(k0, lane0, (uint32_t)x, (uint32_t)x);
    } else {
      store(k0, lane0, recombine(s, 0), recombine(s, 1));
      store(k0 + 8, lane0, recombine(s, 2), recombine(s, 3));
    }
  }
}

// N <= 2^12: one block per row, both passes, the row in shared memory
// between them.  KC1 = max(R, 32) / 32, KC2 = max(C, 32) / 32; at KC1 = KC2
// = 2 (R = C = 64) both passes take the same matrix and fragments.
template <int KC1, int KC2>
__global__ void __launch_bounds__(kRowThreads) mxu_row_kernel(const uint32_t* __restrict__ x,
                                                              uint32_t* __restrict__ out,
                                                              const int4* __restrict__ w_r,
                                                              const int4* __restrict__ w_c,
                                                              const uint32_t* __restrict__ cross, int log_r,
                                                              int log_c) {
  constexpr bool kSameW = KC1 == 2 && KC2 == 2;
  constexpr int kVs = 32 * KC2 + 8;  // words per row of the pass-1 results, = 8 mod 32
  extern __shared__ int4 smem[];
  const int r = 1 << log_r, c = 1 << log_c;
  const int log_rp = log_r < 3 ? 3 : log_r, log_cp = log_c < 3 ? 3 : log_c;  // lanes padded to an n-tile
  const int rp = 1 << log_rp, cp = 1 << log_cp;
  int4* digits = smem;
  uint32_t* vals = reinterpret_cast<uint32_t*>(smem + max(cp * 8 * KC1, rp * 8 * KC2));
  const size_t base = (size_t)blockIdx.x << (log_r + log_c);
  const uint32_t* xr = x + base;

  int4 a1[KC1][4];
  load_frags(a1, w_r, pass_kb(r));
  fill_digits<kRowThreads, KC1, true>(digits, log_cp, [&](int lane, int j0) {
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = lane < c && j0 + q < r ? __ldg(xr + ((j0 + q) << log_c) + lane) : 0u;
    return make_uint4(v[0], v[1], v[2], v[3]);
  });
  __syncthreads();
  dft_pass<kRowThreads, KC1>(a1, digits, r, cp, [&](int k, int lane, uint32_t v0, uint32_t v1) {
    if (k >= r || lane >= c) return;
    const uint32_t* tw = cross + (k << log_c) + lane;
    if (lane + 1 < c)  // 8-byte stores: a half warp's 16 hit all 32 banks
      *reinterpret_cast<uint2*>(vals + k * kVs + lane) = make_uint2(bb::mul(v0, __ldg(tw)), bb::mul(v1, __ldg(tw + 1)));
    else
      vals[k * kVs + lane] = bb::mul(v0, __ldg(tw));
  });
  __syncthreads();
  // pass 2 reads rows r < rp and columns j < 32 KC2: past R and C the words
  // are unwritten, but past C they meet zero columns of W and past R they
  // feed outputs that are dropped
  fill_digits<kRowThreads, KC2, false>(digits, log_rp, [&](int lane, int j0) {
    return *reinterpret_cast<const uint4*>(vals + lane * kVs + j0);
  });
  __syncthreads();
  uint32_t* yr = out + base;
  auto store2 = [&](int k, int lane, uint32_t v0, uint32_t v1) {
    if (k >= c || lane >= r) return;
    yr[(lane << log_c) + k] = v0;
    if (lane + 1 < r) yr[((lane + 1) << log_c) + k] = v1;
  };
  if constexpr (kSameW) {
    dft_pass<kRowThreads, KC2>(a1, digits, c, rp, store2);
  } else {
    int4 a2[KC2][4];
    load_frags(a2, w_c, pass_kb(c));
    dft_pass<kRowThreads, KC2>(a2, digits, c, rp, store2);
  }
}

// N = 2^13, 2^14: one pass over a tile of 32 lanes of a row (M, L >= 32).
// Pass 1 (!kAlongRows): lanes are columns, element (j, lane) at j L + lane,
// the results times the cross twiddles.  Pass 2: lanes are rows, element
// (j, lane) at lane M + j.  Each block reads its tile whole before it
// writes, but src and dst are different buffers.
template <int KC, bool kAlongRows>
__global__ void __launch_bounds__(kTileThreads) mxu_tile_kernel(const uint32_t* __restrict__ src,
                                                            uint32_t* __restrict__ dst,
                                                            const int4* __restrict__ w,
                                                            const uint32_t* __restrict__ cross, int log_m,
                                                            int log_l) {
  __shared__ int4 digits[kTileLanes * 8 * KC];
  const int tiles_log = log_l - 5;
  const long long row = (long long)blockIdx.x >> tiles_log;
  const int lane0 = (int)(blockIdx.x & ((1u << tiles_log) - 1)) * kTileLanes;
  const size_t base = (size_t)row << (log_m + log_l);
  const uint32_t* s = src + base;
  uint32_t* d = dst + base;
  if (kAlongRows) {
    fill_digits<kTileThreads, KC, false>(digits, kLogTileLanes, [&](int lane, int j0) {
      return __ldg(reinterpret_cast<const uint4*>(s + ((size_t)(lane0 + lane) << log_m) + j0));
    });
  } else {
    fill_digits<kTileThreads, KC, true>(digits, kLogTileLanes, [&](int lane, int j0) {
      const uint32_t* col = s + lane0 + lane + ((size_t)j0 << log_l);
      return make_uint4(__ldg(col), __ldg(col + ((size_t)1 << log_l)), __ldg(col + ((size_t)2 << log_l)),
                        __ldg(col + ((size_t)3 << log_l)));
    });
  }
  int4 a[KC][4];
  load_frags(a, w, pass_kb(1 << log_m));
  __syncthreads();
  dft_pass<kTileThreads, KC>(a, digits, 1 << log_m, kTileLanes, [&](int k, int lane, uint32_t v0, uint32_t v1) {
    const int ln = lane0 + lane;
    if (kAlongRows) {
      d[((size_t)ln << log_m) + k] = v0;
      d[((size_t)(ln + 1) << log_m) + k] = v1;
    } else {
      const size_t pos = ((size_t)k << log_l) + ln;
      *reinterpret_cast<uint2*>(d + pos) =
          make_uint2(bb::mul(v0, __ldg(cross + pos)), bb::mul(v1, __ldg(cross + pos + 1)));
    }
  });
}

template <int KC1, int KC2>
void launch_rows(const uint32_t* x, uint32_t* out, const int4* w_r, const int4* w_c, const uint32_t* cross,
                 long long batch, int log_r, int log_c, cudaStream_t st) {
  const int rp = std::max(1 << log_r, 8), cp = std::max(1 << log_c, 8);
  const size_t bytes = 16 * (size_t)std::max(cp * 8 * KC1, rp * 8 * KC2) + 4 * (size_t)rp * (32 * KC2 + 8);
  mxu_row_kernel<KC1, KC2><<<(unsigned)batch, kRowThreads, bytes, st>>>(x, out, w_r, w_c, cross, log_r, log_c);
}

template <int KC, bool kAlongRows>
void launch_tiles(const uint32_t* src, uint32_t* dst, const int4* w, const uint32_t* cross, long long batch,
                  int log_m, int log_l, cudaStream_t st) {
  const long long blocks = batch << (log_l - 5);
  mxu_tile_kernel<KC, kAlongRows><<<(unsigned)blocks, kTileThreads, 0, st>>>(src, dst, w, cross, log_m, log_l);
}

}  // namespace
}  // namespace raiko

// B6 on `batch` rows of 2^(log_r + log_c) elements, x -> out (distinct
// buffers).  w_r, w_c: the R- and C-point DFT matrices packed as A fragments
// (int4 words [kb][kc][i][lane]); cross: the (R, C) Montgomery cross
// twiddles; scratch: batch x N words for N > 2^12, else unused.  log_r <=
// log_c <= log_r + 1 <= 7.
extern "C" int raiko_babybear_ntt_mxu(const void* x, void* out, void* scratch, const void* w_r,
                                      const void* w_c, const void* cross, long long batch, int log_r,
                                      int log_c, void* stream) {
  using namespace raiko;
  const cudaStream_t st = (cudaStream_t)stream;
  if (batch <= 0) return (int)cudaGetLastError();
  if (log_r < 0 || log_c < log_r || log_c > log_r + 1 || log_c > 7) return (int)cudaErrorInvalidValue;
  const uint32_t* xi = (const uint32_t*)x;
  uint32_t* o = (uint32_t*)out;
  const int4* wr = (const int4*)w_r;
  const int4* wc = (const int4*)w_c;
  const uint32_t* tw = (const uint32_t*)cross;
  if (log_r + log_c <= kRowRouteMaxLogN) {
    if (log_c <= 5)
      launch_rows<1, 1>(xi, o, wr, wc, tw, batch, log_r, log_c, st);
    else if (log_r <= 5)
      launch_rows<1, 2>(xi, o, wr, wc, tw, batch, log_r, log_c, st);
    else
      launch_rows<2, 2>(xi, o, wr, wc, tw, batch, log_r, log_c, st);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  uint32_t* a = (uint32_t*)scratch;
  if (log_r == 6)
    launch_tiles<2, false>(xi, a, wr, tw, batch, log_r, log_c, st);
  else
    launch_tiles<4, false>(xi, a, wr, tw, batch, log_r, log_c, st);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  launch_tiles<4, true>(a, o, wc, nullptr, batch, log_c, log_r, st);
  return (int)cudaGetLastError();
}
