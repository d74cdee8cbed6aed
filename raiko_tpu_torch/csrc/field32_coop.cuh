// Warp-cooperative Montgomery field arithmetic and the complete a = 0 point
// formulas, for one serial chain of point operations spread over a warp
// (kernels B2 and B4).
//
// A field element lives in a group of W lanes, one 32-bit limb per lane:
// lane j of the group holds limb j (little-endian), and lanes N..W-1 of a
// group of W > N lanes hold 0.  A warp has G = 32 / W groups.  Each group
// holds every value of the chain (the groups compute the additions
// redundantly, which costs no time in a latency-bound chain), and the
// Montgomery products of one layer of a point formula are dealt out over
// the groups, K = ceil(M / G) products per lane interleaved so that their
// latencies overlap; a shuffle then gives every group every product.
//
// Every operation returns the canonical value in [0, p), as field32.cuh's
// do.  A Montgomery product of canonical inputs, a b R^-1 mod p, is one
// number however its limb products and carries are scheduled, so a chain
// that runs the same sequence of field operations as field32.cuh (and the
// reference's kzg/curve.py and ops/secp.py) returns the same bits.
//
// Carries never ripple lane by lane.  For a limb-wise sum with generate
// bits g (carry out of the limb) and propagate bits p (limb all ones),
// which are disjoint for a sum of two limbs, the carry into every limb at
// once is ((g | p) + g) ^ p on the two ballot masks; bit N is the carry out
// of the top limb.  Borrows of a difference resolve the same way, with
// generate a < b and propagate a == b.  A sum and its conditional
// subtraction of p take two such rounds.  (Settling both in one round, each
// lane voting the second chain's bits for either carry it may receive,
// ran slower on the H100: the extra votes and mask work cost more than the
// round saves.)
//
// The product is CIOS with the accumulator one limb per lane in carry-save
// form: lane j keeps a 64-bit column sum c_j < 2^38.  Step i adds
// a_j b_i + m p_j and shifts down one limb (a shuffle from lane j + 1); m
// comes from lane 0's low word and is broadcast by a shuffle.  This chain of
// N dependent broadcasts and shifts is the product's latency.  One
// normalisation (a shuffle of the high words and one ballot carry pass)
// and a conditional subtraction of p end it.
//
// A field is a traits struct Fd with N, NP0 and p(i) as in field32.cuh, and
//   static constexpr uint32_t B3;           // 3b of y^2 = x^3 + b
#pragma once

#include <cstdint>

namespace raiko {

constexpr uint32_t kFullMask = 0xffffffffu;

__host__ __device__ constexpr int top_bit(uint32_t v) { return v <= 1 ? 0 : 1 + top_bit(v >> 1); }

// This lane's place in its group of W lanes, and its limb of p.
template <class Fd, int W>
struct Lanes {
  static constexpr int N = Fd::N;
  static constexpr int G = 32 / W;
  static constexpr uint32_t LIMBS = (1u << N) - 1;
  static_assert(N <= W && W <= 16 && 32 % W == 0, "a group is 8 or 16 lanes holding N <= W limbs");

  uint32_t j;     // limb index, lane % W
  uint32_t base;  // the group's first lane
  uint32_t pj;    // limb j of p (0 past N)
  uint32_t live;  // 1 for a limb lane, 0 for padding

  __device__ __forceinline__ Lanes() {
    const uint32_t lane = threadIdx.x & 31u;
    j = lane & (W - 1);
    base = lane - j;
    live = j < (uint32_t)N ? 1u : 0u;
    pj = live ? Fd::p(j) : 0u;
  }
  __device__ __forceinline__ uint32_t group() const { return base / W; }
  __device__ __forceinline__ uint32_t keep() const { return 0u - live; }
  // bit j: pred of limb j of this lane's group
  __device__ __forceinline__ uint32_t vote(bool pred) const {
    return (__ballot_sync(kFullMask, pred) >> base) & LIMBS;
  }
  // bit j of a group mask, 0 on padding lanes
  __device__ __forceinline__ uint32_t bit(uint32_t mask) const { return (mask >> j) & live; }
};

// Carry into each limb (bit N: out of the top limb) from disjoint generate
// and propagate masks.
__device__ __forceinline__ uint32_t carry_ins(uint32_t g, uint32_t p) { return ((g | p) + g) ^ p; }

// t - p if (top != 0 or t >= p) else t, for t + top 2^(32N) < 2p.
template <class Fd, int W>
__device__ __forceinline__ uint32_t c_reduce_once(const Lanes<Fd, W>& L, uint32_t t, uint32_t top) {
  const uint32_t b = carry_ins(L.vote(t < L.pj), L.vote(t == L.pj));
  const uint32_t d = t - L.pj - L.bit(b);
  const bool ge = top != 0 || ((b >> Fd::N) & 1u) == 0;
  return (ge ? d : t) & L.keep();
}

template <class Fd, int W>
__device__ __forceinline__ uint32_t c_add(const Lanes<Fd, W>& L, uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a + b;
  const uint32_t lo = (uint32_t)s;
  const uint32_t c = carry_ins(L.vote((s >> 32) != 0), L.vote(lo == kFullMask));
  return c_reduce_once(L, lo + L.bit(c), (c >> Fd::N) & 1u);
}

template <class Fd, int W>
__device__ __forceinline__ uint32_t c_sub(const Lanes<Fd, W>& L, uint32_t a, uint32_t b) {
  const uint32_t br = carry_ins(L.vote(a < b), L.vote(a == b));
  const uint32_t d = a - b - L.bit(br);
  const uint64_t s = (uint64_t)d + (L.pj & (0u - ((br >> Fd::N) & 1u)));
  const uint32_t lo = (uint32_t)s;
  const uint32_t c = carry_ins(L.vote((s >> 32) != 0), L.vote(lo == kFullMask));
  return (lo + L.bit(c)) & L.keep();
}

// b3 a by left-to-right doubling and adding; every step is canonical, so
// any chain gives field32.cuh's mul_b3 value.
template <class Fd, int W>
__device__ __forceinline__ uint32_t c_mul_b3(const Lanes<Fd, W>& L, uint32_t a) {
  uint32_t r = a;
#pragma unroll
  for (int i = top_bit(Fd::B3) - 1; i >= 0; --i) {
    r = c_add(L, r, r);
    if ((Fd::B3 >> i) & 1u) r = c_add(L, r, a);
  }
  return r;
}

// K independent CIOS products r[k] = a[k] b[k] R^-1 mod p, interleaved.
template <class Fd, int W, int K>
__device__ __forceinline__ void c_mul(const Lanes<Fd, W>& L, uint32_t (&r)[K], const uint32_t (&a)[K],
                                      const uint32_t (&b)[K]) {
  constexpr int N = Fd::N;
  uint64_t c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t bi = __shfl_sync(kFullMask, b[k], i, W);
      const uint64_t ab = (uint64_t)a[k] * bi;
      // lane 0's (c_0 + a_0 b_i) NP0 makes limb 0 of the step's sum 0
      const uint32_t m = __shfl_sync(kFullMask, ((uint32_t)c[k] + (uint32_t)ab) * Fd::NP0, 0, W);
      const uint64_t mp = (uint64_t)m * L.pj;
      const uint64_t x = c[k] + (uint32_t)ab + (uint32_t)mp;  // column j
      const uint64_t y = (ab >> 32) + (mp >> 32);              // into column j + 1
      unsigned long long xn = __shfl_down_sync(kFullMask, (unsigned long long)x, 1, W);
      if (L.j == (uint32_t)(W - 1)) xn = 0;
      // divide by 2^32: column j + 1 moves to lane j; column 0 (0 mod 2^32)
      // passes its carry on
      c[k] = xn + y + (L.j == 0 ? (x >> 32) : 0);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t hi = (uint32_t)(c[k] >> 32);
    uint32_t up = __shfl_up_sync(kFullMask, hi, 1, W);
    if (L.j == 0) up = 0;
    const uint64_t s = (uint64_t)(uint32_t)c[k] + up;
    const uint32_t lo = (uint32_t)s;
    const uint32_t cc = carry_ins(L.vote((s >> 32) != 0), L.vote(lo == kFullMask));
    const uint32_t top = __shfl_sync(kFullMask, hi, N - 1, W) + ((cc >> N) & 1u);
    r[k] = c_reduce_once(L, lo + L.bit(cc), top);
  }
}

// One layer of M independent products dealt out over the G groups: group g
// computes products g, g + G, ...; every lane returns with limb j of all M.
template <class Fd, int W, int M>
__device__ __forceinline__ void c_mul_layer(const Lanes<Fd, W>& L, uint32_t (&r)[M], const uint32_t (&a)[M],
                                            const uint32_t (&b)[M]) {
  constexpr int G = Lanes<Fd, W>::G;
  constexpr int K = (M + G - 1) / G;
  const uint32_t g = L.group();
  uint32_t as[K], bs[K], rs[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    // a slot past M repeats product M - 1; its result is never read
    as[s] = a[s * G < M ? s * G : M - 1];
    bs[s] = b[s * G < M ? s * G : M - 1];
#pragma unroll
    for (int h = 1; h < G; ++h) {
      if (s * G + h < M && g == (uint32_t)h) {
        as[s] = a[s * G + h];
        bs[s] = b[s * G + h];
      }
    }
  }
  c_mul<Fd, W, K>(L, rs, as, bs);
#pragma unroll
  for (int k = 0; k < M; ++k) r[k] = __shfl_sync(kFullMask, rs[k / G], (k % G) * W + L.j);
}

// A projective point, limb j of each coordinate in this lane.
struct CPoint {
  uint32_t x, y, z;
};

// Complete doubling, RCB15 Alg. 9 (a = 0): DoubleOp's in
// bls12_381_g1.cu, value for value, its 8 products in two layers of 4.
template <class Fd, int W>
__device__ __forceinline__ CPoint c_double(const Lanes<Fd, W>& L, const CPoint& p) {
  uint32_t t[4];
  {
    const uint32_t a[4] = {p.y, p.y, p.z, p.x}, b[4] = {p.y, p.z, p.z, p.y};
    c_mul_layer<Fd, W, 4>(L, t, a, b);  // t0 = Y^2, t1 = YZ, t2 = Z^2, txy = XY
  }
  uint32_t z3 = c_add(L, t[0], t[0]);
  z3 = c_add(L, z3, z3);
  z3 = c_add(L, z3, z3);  // 8 Y^2
  const uint32_t t2b = c_mul_b3(L, t[2]);
  uint32_t u = c_add(L, t2b, t2b);
  u = c_add(L, u, t2b);  // 3 t2b
  const uint32_t y3a = c_add(L, t[0], t2b);
  const uint32_t t0b = c_sub(L, t[0], u);
  // X3 = 2 t0b txy ; Y3 = t2b z3 + t0b y3a ; Z3 = t1 z3
  uint32_t m[4];
  {
    const uint32_t a[4] = {t0b, t2b, t0b, t[1]}, b[4] = {t[3], z3, y3a, z3};
    c_mul_layer<Fd, W, 4>(L, m, a, b);
  }
  return {c_add(L, m[0], m[0]), c_add(L, m[1], m[2]), m[3]};
}

// Complete addition, RCB15 Alg. 7 (a = 0): the reference's kzg/curve.py
// and ops/secp.py add, value for value, its 12 products in two layers of 6.
template <class Fd, int W>
__device__ __forceinline__ CPoint c_point_add(const Lanes<Fd, W>& L, const CPoint& p, const CPoint& q) {
  uint32_t t[6];
  {
    const uint32_t a[6] = {p.x, p.y, p.z, c_add(L, p.x, p.y), c_add(L, p.y, p.z), c_add(L, p.x, p.z)};
    const uint32_t b[6] = {q.x, q.y, q.z, c_add(L, q.x, q.y), c_add(L, q.y, q.z), c_add(L, q.x, q.z)};
    c_mul_layer<Fd, W, 6>(L, t, a, b);  // t0, t1, t2, s1, s2, s3
  }
  const uint32_t t3 = c_sub(L, t[3], c_add(L, t[0], t[1]));   // s1 - (t0 + t1)
  const uint32_t t4 = c_sub(L, t[4], c_add(L, t[1], t[2]));   // s2 - (t1 + t2)
  const uint32_t y3a = c_sub(L, t[5], c_add(L, t[0], t[2]));  // s3 - (t0 + t2)
  const uint32_t t0b = c_add(L, c_add(L, t[0], t[0]), t[0]);  // 3 t0
  const uint32_t t2b = c_mul_b3(L, t[2]);
  const uint32_t y3b = c_mul_b3(L, y3a);
  const uint32_t z3a = c_add(L, t[1], t2b);
  const uint32_t t1b = c_sub(L, t[1], t2b);
  // X3 = t3 t1b - t4 y3b ; Y3 = t1b z3a + y3b t0b ; Z3 = z3a t4 + t0b t3
  uint32_t m[6];
  {
    const uint32_t a[6] = {t4, t3, t1b, y3b, z3a, t0b}, b[6] = {y3b, t1b, z3a, t0b, t4, t3};
    c_mul_layer<Fd, W, 6>(L, m, a, b);
  }
  return {c_sub(L, m[1], m[0]), c_add(L, m[2], m[3]), c_add(L, m[4], m[5])};
}

// Limb j of point k of a contiguous (M, 3, N) array; 0 on padding lanes.
template <class Fd, int W>
__device__ __forceinline__ CPoint c_load(const Lanes<Fd, W>& L, const uint32_t* src) {
  if (!L.live) return {0u, 0u, 0u};
  return {src[L.j], src[Fd::N + L.j], src[2 * Fd::N + L.j]};
}

// Group 0 writes the point.
template <class Fd, int W>
__device__ __forceinline__ void c_store(const Lanes<Fd, W>& L, uint32_t* dst, const CPoint& p) {
  if (L.base != 0 || !L.live) return;
  dst[L.j] = p.x;
  dst[Fd::N + L.j] = p.y;
  dst[2 * Fd::N + L.j] = p.z;
}

}  // namespace raiko
