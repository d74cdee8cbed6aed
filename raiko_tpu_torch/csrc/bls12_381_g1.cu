// BLS12-381 G1 kernels for Hopper (sm_90a): B1 batched complete addition,
// B2 the weighted Horner fold of the Pippenger MSM and B3 batched complete
// doubling.
//
// Replaces raiko_tpu/ops/ec_pallas.py: ec_add (kernel _add_kernel),
// ec_weighted_fold (kernel _fold_kernel) and ec_double (kernel
// _double_kernel).
//
// Layout: a point is (3, 12) little-endian 32-bit limbs, Montgomery form
// with R = 2^384, contiguous (M, 3, 12); the wrappers in ops/ec_cuda.py
// pass torch int32 tensors that carry the u32 bits.
//
// What bounds these on the card, and the design:
// * B1 is bound by integer multiplies, not bytes: one addition is 12 CIOS
//   products of 12 x 12 limbs (588 32-bit multiplies each with the
//   reductions) against 432 bytes moved.  The served MSM launches it at
//   about 80 to 63,000 pairs, mostly below one wave of the card, so there a
//   launch costs the latency of one addition, which one thread per pair
//   would make 12 products long.  RCB15 Alg. 7 is two layers of six
//   independent products with additions between them, so a pair runs on a
//   group of S lanes, each running ceil(6 / S) products of a layer, the
//   values passing between the lanes through shared memory
//   (ec_split_kernel<AddOp, S>).  S = 8 (6 lanes busy) makes an addition two
//   products deep: 6.3 us a launch at 256 pairs, 8.9 us at 4,096 on an
//   H100 80GB HBM3 (700 W).  S = 2 leaves no lane idle, and at 80 registers
//   and 37 KB of shared memory a block an SM keeps 24 warps: 0.156 ms at
//   131,072 pairs, 35% of the multiply bound, against 0.28 ms one thread
//   per pair.  The wrapper takes S = 8 up to 8,192 pairs and S = 2 above,
//   where the two cross (ops/ec_cuda.py).  The products are field32.cuh's,
//   in PTX carry chains; ptxas (nvcc 12.9, sm_90a, -O3) gives the S = 8
//   kernel 64 registers and the S = 2 kernel 80, no spills.  The build log
//   beside the library keeps the report.
// * B2 is a serial chain per batch entry: 255 doublings and 255 additions
//   in Horner order (acc = v[J-1]; acc = 2 acc + v[j]), and the MSM calls
//   it at batch 1.  No reordering shortens it (any addition chain for
//   2^255 v_255 has 255 dependent doublings), so it is bound by the
//   latency of its dependent field operations, not by any throughput: one
//   thread per entry would run a step's 20 Montgomery products one after
//   another (19.6 ms per fold on the H100 above).  So one warp runs one
//   entry's chain (field32_coop.cuh): a field element is spread over a group of 16 lanes, one limb per lane (12 live), so a
//   product is 12 shuffle-linked CIOS steps instead of 144 dependent
//   multiply-adds, and carries resolve through ballots, not a ripple.  The
//   two groups of the warp split each layer of independent products (RCB15
//   addition: two layers of 6, 3 per lane; doubling: two of 4, 2 per lane),
//   so a step has 4 dependent product layers.  The next point is loaded a
//   step ahead, so no step waits on device memory, and any J >= 1 runs.
//   The field operations are field32.cuh's, in its order, and each result
//   is canonical, so the output equals the plain version bit for bit.  One
//   block of one warp per entry.  ptxas (nvcc 12.9, sm_90a, -O3) gives
//   weighted_fold_kernel 47 registers, no spills.  On the H100 above a fold
//   at B = 1, J = 256 took 1.24 ms, 4.9 us per Horner step: still the
//   chain's latency (4 product layers of 12 shuffle-linked steps, and about
//   16 dependent additions, each two ballot rounds), not a throughput.
// * B3 is RCB15 Alg. 9: 8 CIOS products per point against 288 bytes
//   moved, so integer multiplies bound it too.  Alg. 9 is two layers of four
//   independent products, so a point runs on B1's machinery
//   (ec_split_kernel<DoubleOp, 4>), which one thread per point (125
//   registers, 0.149 ms at 131,072 points) left unused.  S = 4 (one
//   product of a layer per lane) makes a doubling two products deep, and
//   at 56 registers and 18.7 KB of shared memory a block an SM keeps more
//   warps than S = 2 did (72 registers, 37 KB; measured and not kept): on
//   the H100 above S = 4 was as fast as S = 2 or faster at every width
//   from 256 points (6.0 us a launch against 10.2, and 29.2 one thread
//   per point) to 131,072 (0.0975 ms against 0.103; 38% of the multiply
//   bound), the two equal at 16,384, so every width takes S = 4.  ptxas
//   (nvcc 12.9, sm_90a, -O3) gives it 56 registers, no spills.
// The Pallas kernels' TPU layout (limbs on sublanes, six products stacked
// along lanes, deferred Kogge-Stone carries) does not carry over.

#include <cuda_runtime.h>

#include "field32.cuh"
#include "field32_coop.cuh"

namespace raiko {

__constant__ uint32_t kBlsP[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

struct BlsFp {
  static constexpr int N = 12;
  static constexpr uint32_t NP0 = 0xfffcfffdu;  // -p^-1 mod 2^32
  static constexpr uint32_t B3 = 12;
  __device__ static __forceinline__ uint32_t p(int i) { return kBlsP[i]; }
  // b3 = 3 * 4 = 12: 12a = 8a + 4a.  r may alias a.
  __device__ static __forceinline__ void mul_b3(uint32_t (&r)[N], const uint32_t (&a)[N]) {
    uint32_t a4[N], a8[N];
    fadd<BlsFp>(a4, a, a);
    fadd<BlsFp>(a4, a4, a4);
    fadd<BlsFp>(a8, a4, a4);
    fadd<BlsFp>(r, a8, a4);
  }
};

// ---- kernels -----------------------------------------------------------

// B1 and B3, one item (a pair to add, a point to double) over a group of S
// lanes, by product.  RCB15 Alg. 7 and Alg. 9 are each two layers of
// independent Montgomery products (6 and 4) with additions between them; a
// lane runs K = ceil(products / S) products of a layer (lane l the products
// l, l + S, ...).  Values pass between the lanes of a group through shared
// memory, each 12-limb value at its own 12 words: region A holds the item's
// inputs, then the second layer's operands D, then the output; region B the
// first layer's products, then the second's.  Each item's slice of a region
// is 73 words, so the groups of a warp read different banks.  A warp owns
// 32 / S consecutive items and loads and stores them whole, coalesced; only
// __syncwarp orders the phases.  The formula is a struct Op:
//   kInputs         points in (2: p then q; 1: p)
//   kProducts       products per layer
//   kDerived        second-layer operands D
//   layer1(k, A, x, y)  operands of first-layer product k
//   derive(k, B, d)     D_k from the first layer's products
//   op_a(k), op_b(k)    the D indices of second-layer product k
//   finish(c, B, r)     output coordinate c from the second layer's products
// Every field operation returns a canonical value, so the output equals the
// plain version's bit for bit whatever the grouping.
constexpr int kSplitStride = 73;
constexpr int kSplitWarps = 4;

// Limb j of value v of one item's slice.
__device__ __forceinline__ void sm_load(uint32_t (&r)[12], const uint32_t* s, int v) {
#pragma unroll
  for (int j = 0; j < 12; ++j) r[j] = s[12 * v + j];
}
__device__ __forceinline__ void sm_store(uint32_t* s, int v, const uint32_t (&a)[12]) {
#pragma unroll
  for (int j = 0; j < 12; ++j) s[12 * v + j] = a[j];
}
__device__ __forceinline__ void select12(uint32_t (&r)[12], bool c, const uint32_t (&a)[12],
                                         const uint32_t (&b)[12]) {
#pragma unroll
  for (int j = 0; j < 12; ++j) r[j] = c ? a[j] : b[j];
}

// RCB15 Alg. 7, complete addition (B1).  A: p (X1, Y1, Z1) at values 0-2,
// q at 3-5.  Layer 1: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2,
// s1 = (X1 + Y1)(X2 + Y2), s2 = (Y1 + Z1)(Y2 + Z2), s3 = (X1 + Z1)(X2 + Z2).
// D, from B's t0, t1, t2, s1, s2, s3 (values 0-5), in one shape per pair
// of them (with S = 2 a slot holds one pair, so the warp takes one branch):
//   D0 = t3 = s1 - (t0 + t1)          D1 = t4 = s2 - (t1 + t2)
//   D2 = y3b = b3 (s3 - (t0 + t2))    D3 = t0b = t0 + (t0 + t0)
//   D4 = z3a = t1 + b3 t2             D5 = t1b = t1 - b3 t2
// Layer 2: m0 = t4 y3b, m1 = t3 t1b, m2 = t1b z3a, m3 = y3b t0b,
// m4 = z3a t4, m5 = t0b t3.  X3 = m1 - m0, Y3 = m3 + m2, Z3 = m5 + m4.
struct AddOp {
  static constexpr int kInputs = 2, kProducts = 6, kDerived = 6;
  __device__ static __forceinline__ void layer1(int k, const uint32_t* A, uint32_t (&x)[12],
                                                uint32_t (&y)[12]) {
    const int u = k < 3 ? k : (k == 4 ? 1 : 0), v = k == 3 ? 1 : 2;
    uint32_t pu[12], pv[12], qu[12], qv[12], ps[12], qs[12];
    sm_load(pu, A, u);
    sm_load(pv, A, v);
    sm_load(qu, A, 3 + u);
    sm_load(qv, A, 3 + v);
    fadd<BlsFp>(ps, pu, pv);
    fadd<BlsFp>(qs, qu, qv);
    select12(x, k >= 3, ps, pu);
    select12(y, k >= 3, qs, qu);
  }
  __device__ static __forceinline__ void derive(int k, const uint32_t* B, uint32_t (&d)[12]) {
    uint32_t x[12], y[12];
    if (k < 2) {
      uint32_t z[12];
      sm_load(x, B, 3 + k);
      sm_load(y, B, k);
      sm_load(z, B, k + 1);
      fadd<BlsFp>(y, y, z);
      fsub<BlsFp>(d, x, y);
    } else if (k < 4) {
      uint32_t z[12], sum[12], dif[12];
      sm_load(x, B, k == 2 ? 5 : 0);
      sm_load(y, B, 0);
      sm_load(z, B, k == 2 ? 2 : 0);
      fadd<BlsFp>(y, y, z);
      fadd<BlsFp>(sum, x, y);
      fsub<BlsFp>(dif, x, y);
      BlsFp::mul_b3(dif, dif);
      select12(d, k == 2, dif, sum);
    } else {
      uint32_t sum[12], dif[12];
      sm_load(x, B, 1);
      sm_load(y, B, 2);
      BlsFp::mul_b3(y, y);
      fadd<BlsFp>(sum, x, y);
      fsub<BlsFp>(dif, x, y);
      select12(d, k == 4, sum, dif);
    }
  }
  __host__ __device__ static constexpr int op_a(int k) {
    return k == 0 ? 1 : k == 1 ? 0 : k == 2 ? 5 : k == 3 ? 2 : k == 4 ? 4 : 3;
  }
  __host__ __device__ static constexpr int op_b(int k) {
    return k == 0 ? 2 : k == 1 ? 5 : k == 2 ? 4 : k == 3 ? 3 : k == 4 ? 1 : 0;
  }
  __device__ static __forceinline__ void finish(int c, const uint32_t* B, uint32_t (&r)[12]) {
    uint32_t x[12], y[12], sum[12], dif[12];
    sm_load(x, B, 2 * c + 1);
    sm_load(y, B, 2 * c);
    fadd<BlsFp>(sum, x, y);
    fsub<BlsFp>(dif, x, y);
    select12(r, c == 0, dif, sum);
  }
};

// RCB15 Alg. 9, complete doubling (B3), in the reference's order.  A: p
// (X, Y, Z) at values 0-2.  Layer 1: t0 = Y^2, t1 = Y Z, t2 = Z^2,
// txy = X Y.  D, from B's t0, t1, t2, txy (values 0-3), a pair of them per
// shape:
//   D0 = t0b = t0 - 3 t2b, t2b = b3 t2      D1 = t2b
//   D2 = z3 = 8 t0                          D3 = y3a = t0 + t2b
//   D4 = txy                                D5 = t1
// Layer 2: m0 = t0b txy, m1 = t2b z3, m2 = t0b y3a, m3 = t1 z3.
// X3 = m0 + m0, Y3 = m1 + m2, Z3 = m3.
struct DoubleOp {
  static constexpr int kInputs = 1, kProducts = 4, kDerived = 6;
  __device__ static __forceinline__ void layer1(int k, const uint32_t* A, uint32_t (&x)[12],
                                                uint32_t (&y)[12]) {
    sm_load(x, A, k == 3 ? 0 : (k == 2 ? 2 : 1));
    sm_load(y, A, k == 0 || k == 3 ? 1 : 2);
  }
  __device__ static __forceinline__ void derive(int k, const uint32_t* B, uint32_t (&d)[12]) {
    if (k < 4) {
      uint32_t t0[12], t2b[12], u[12], v[12];
      sm_load(t0, B, 0);
      sm_load(t2b, B, 2);
      BlsFp::mul_b3(t2b, t2b);
      if (k < 2) {
        fadd<BlsFp>(u, t2b, t2b);
        fadd<BlsFp>(u, u, t2b);
        fsub<BlsFp>(v, t0, u);
        select12(d, k == 0, v, t2b);
      } else {
        fadd<BlsFp>(u, t0, t0);
        fadd<BlsFp>(u, u, u);
        fadd<BlsFp>(u, u, u);
        fadd<BlsFp>(v, t0, t2b);
        select12(d, k == 2, u, v);
      }
    } else {
      sm_load(d, B, k == 4 ? 3 : 1);
    }
  }
  __host__ __device__ static constexpr int op_a(int k) { return k == 0 ? 0 : k == 1 ? 1 : k == 2 ? 0 : 5; }
  __host__ __device__ static constexpr int op_b(int k) { return k == 0 ? 4 : k == 1 ? 2 : k == 2 ? 3 : 2; }
  __device__ static __forceinline__ void finish(int c, const uint32_t* B, uint32_t (&r)[12]) {
    uint32_t x[12], y[12], sum[12];
    sm_load(x, B, c == 0 ? 0 : (c == 1 ? 1 : 3));
    sm_load(y, B, c == 0 ? 0 : 2);
    fadd<BlsFp>(sum, x, y);
    select12(r, c == 2, x, sum);
  }
};

template <class Op, int S>
__global__ void __launch_bounds__(32 * kSplitWarps) ec_split_kernel(const uint32_t* __restrict__ p,
                                                                    const uint32_t* __restrict__ q,
                                                                    uint32_t* __restrict__ out,
                                                                    long long m) {
  constexpr int NP = Op::kProducts;
  constexpr int K = (NP + S - 1) / S;              // products per lane per layer
  constexpr int KD = (Op::kDerived + S - 1) / S;   // D values per lane
  constexpr int ITEMS = 32 / S;                    // items per warp
  constexpr int IN = 36 * Op::kInputs;             // input words per item
  __shared__ uint32_t smem[kSplitWarps][2][ITEMS * kSplitStride];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item0 = ((long long)blockIdx.x * kSplitWarps + warp) * ITEMS;
  if (item0 >= m) return;  // the whole warp
  const int ni = m - item0 < ITEMS ? (int)(m - item0) : ITEMS;
  uint32_t* a_all = smem[warp][0];
  uint32_t* b_all = smem[warp][1];
  for (int i = lane; i < ni * 36; i += 32) {
    const int k = i / 36, w = i % 36;
    a_all[k * kSplitStride + w] = p[(item0 + k) * 36 + w];
    if (Op::kInputs == 2) a_all[k * kSplitStride + 36 + w] = q[(item0 + k) * 36 + w];
  }
  static_assert(IN <= kSplitStride && 12 * Op::kDerived <= kSplitStride, "an item's values exceed its slice");
  __syncwarp();
  const int l = lane % S;
  uint32_t* A = a_all + (lane / S) * kSplitStride;
  uint32_t* B = b_all + (lane / S) * kSplitStride;
  // slot s of this lane is product k = l + S s; a slot past the last repeats
  // the last and is not stored
  int ks[K];
#pragma unroll
  for (int s = 0; s < K; ++s) ks[s] = l + S * s < NP ? l + S * s : NP - 1;

  {
    uint32_t x[K][12], y[K][12];
#pragma unroll
    for (int s = 0; s < K; ++s) Op::layer1(ks[s], A, x[s], y[s]);
#pragma unroll
    for (int s = 0; s < K; ++s) fmul<BlsFp>(x[s], x[s], y[s]);
#pragma unroll
    for (int s = 0; s < K; ++s)
      if (l + S * s < NP) sm_store(B, ks[s], x[s]);
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < KD; ++s) {
    const int k = l + S * s < Op::kDerived ? l + S * s : Op::kDerived - 1;
    uint32_t d[12];
    Op::derive(k, B, d);
    if (l + S * s < Op::kDerived) sm_store(A, k, d);  // A's inputs are dead: read before the last sync
  }
  __syncwarp();
  {
    uint32_t x[K][12], y[K][12];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      int ia = 0, ib = 0;
#pragma unroll
      for (int c = 0; c < NP; ++c)
        if (ks[s] == c) { ia = Op::op_a(c); ib = Op::op_b(c); }
      sm_load(x[s], A, ia);
      sm_load(y[s], A, ib);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) fmul<BlsFp>(x[s], x[s], y[s]);
#pragma unroll
    for (int s = 0; s < K; ++s)
      if (l + S * s < NP) sm_store(B, ks[s], x[s]);
  }
  __syncwarp();
  // output coordinate c on lane c % S
#pragma unroll
  for (int s = 0; s < (3 + S - 1) / S; ++s) {
    const int c = l + S * s < 3 ? l + S * s : 2;
    uint32_t r[12];
    Op::finish(c, B, r);
    if (l + S * s < 3) sm_store(A, c, r);
  }
  __syncwarp();
  for (int i = lane; i < ni * 36; i += 32) {
    const int k = i / 36, w = i % 36;
    out[(item0 + k) * 36 + w] = a_all[k * kSplitStride + w];
  }
}

template <class Op, int S>
void launch_split(const uint32_t* p, const uint32_t* q, uint32_t* out, long long m, cudaStream_t st) {
  constexpr unsigned threads = 32 * kSplitWarps;
  ec_split_kernel<Op, S><<<(unsigned)((S * m + threads - 1) / threads), threads, 0, st>>>(p, q, out, m);
}

// out[b] = sum_j 2^j v[b, j] as acc = v[J-1]; acc = 2 acc + v[j] for
// j = J-2..0.  One warp per entry: block b folds entry b.
__global__ void __launch_bounds__(32) weighted_fold_kernel(const uint32_t* __restrict__ v,
                                                           uint32_t* __restrict__ out, int j) {
  using L = Lanes<BlsFp, 16>;
  const L lanes;
  const uint32_t* row = v + (long long)blockIdx.x * j * 36;
  CPoint acc = c_load(lanes, row + (long long)(j - 1) * 36);
  CPoint next = j >= 2 ? c_load(lanes, row + (long long)(j - 2) * 36) : acc;
  for (int k = j - 2; k >= 0; --k) {
    const CPoint cur = next;
    if (k > 0) next = c_load(lanes, row + (long long)(k - 1) * 36);
    acc = c_double(lanes, acc);
    acc = c_point_add(lanes, acc, cur);
  }
  c_store(lanes, out + (long long)blockIdx.x * 36, acc);
}

}  // namespace raiko

extern "C" int raiko_bls12_381_ec_add(const void* p, const void* q, void* out, long long m, int lanes,
                                      void* stream) {
  using namespace raiko;
  if (m <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* pp = (const uint32_t*)p;
  const uint32_t* qq = (const uint32_t*)q;
  uint32_t* oo = (uint32_t*)out;
  switch (lanes) {
    case 2: launch_split<AddOp, 2>(pp, qq, oo, m, st); break;
    case 8: launch_split<AddOp, 8>(pp, qq, oo, m, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int raiko_bls12_381_ec_double(const void* p, void* out, long long m, void* stream) {
  if (m > 0) {
    raiko::launch_split<raiko::DoubleOp, 4>((const uint32_t*)p, nullptr, (uint32_t*)out, m,
                                            (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

extern "C" int raiko_bls12_381_weighted_fold(const void* v, void* out, long long batch, int j,
                                             void* stream) {
  if (batch > 0) {
    raiko::weighted_fold_kernel<<<(unsigned)batch, 32, 0, (cudaStream_t)stream>>>((const uint32_t*)v,
                                                                                (uint32_t*)out, j);
  }
  return (int)cudaGetLastError();
}
