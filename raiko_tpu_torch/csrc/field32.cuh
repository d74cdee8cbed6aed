// Montgomery field arithmetic and complete short-Weierstrass (a = 0) point
// formulas over 32-bit limbs, one field element per thread: the batched
// BLS12-381 G1 kernels B1 and B3.  The serial chains B2 and B4 run the same
// operations spread over a warp (field32_coop.cuh).
//
// A field element is N little-endian 32-bit limbs held in registers.  The
// Montgomery radix is R = 2^(32N), which equals the public layout's
// 2^(16 * 2N), so Montgomery values match the 16-bit-limb reference bit for
// bit.  Every operation returns a canonical value in [0, p).
//
// A field is a traits struct Fd with
//   static constexpr int N;                 // limbs
//   static constexpr uint32_t NP0;          // -p^-1 mod 2^32
//   __device__ static uint32_t p(int i);    // limb i of p
//   __device__ static void mul_b3(uint32_t (&r)[N], const uint32_t (&a)[N]);
// where mul_b3 multiplies by b3 = 3b of the curve y^2 = x^3 + b.
#pragma once

#include <cstdint>

namespace raiko {

// r = t - p if (top != 0 or t >= p) else t, for t + top * 2^(32N) < 2p.
template <class Fd>
__device__ __forceinline__ void reduce_once(uint32_t (&r)[Fd::N], const uint32_t (&t)[Fd::N],
                                            uint32_t top) {
  constexpr int N = Fd::N;
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)t[j] - Fd::p(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  const bool ge = (top != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = ge ? d[j] : t[j];
}

template <class Fd>
__device__ __forceinline__ void fadd(uint32_t (&r)[Fd::N], const uint32_t (&a)[Fd::N],
                                     const uint32_t (&b)[Fd::N]) {
  constexpr int N = Fd::N;
  uint32_t s[N];
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t v = (uint64_t)a[j] + b[j] + carry;
    s[j] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
  reduce_once<Fd>(r, s, carry);
}

template <class Fd>
__device__ __forceinline__ void fsub(uint32_t (&r)[Fd::N], const uint32_t (&a)[Fd::N],
                                     const uint32_t (&b)[Fd::N]) {
  constexpr int N = Fd::N;
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 32) & 1u;
  }
  // on borrow add p back; the carry out of that add cancels the borrow
  const uint32_t mask = 0u - borrow;
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t v = (uint64_t)d[j] + (Fd::p(j) & mask) + carry;
    r[j] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
}

// CIOS Montgomery product a * b * R^-1 mod p, inputs in [0, p).
template <class Fd>
__device__ __forceinline__ void fmul(uint32_t (&r)[Fd::N], const uint32_t (&a)[Fd::N],
                                     const uint32_t (&b)[Fd::N]) {
  constexpr int N = Fd::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * Fd::NP0;
    s = (uint64_t)m * Fd::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * Fd::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  // t[0..N-1] + t[N] * 2^(32N) < 2p
  uint32_t lo[N];
#pragma unroll
  for (int j = 0; j < N; ++j) lo[j] = t[j];
  reduce_once<Fd>(r, lo, t[N]);
}

template <class Fd>
struct Point {
  uint32_t x[Fd::N], y[Fd::N], z[Fd::N];
};

// (x, y, z) = P[i] from a contiguous (M, 3, N) array of 32-bit limbs.
template <class Fd>
__device__ __forceinline__ void load_point(Point<Fd>& p, const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < Fd::N; ++j) {
    p.x[j] = src[j];
    p.y[j] = src[Fd::N + j];
    p.z[j] = src[2 * Fd::N + j];
  }
}

template <class Fd>
__device__ __forceinline__ void store_point(uint32_t* dst, const Point<Fd>& p) {
#pragma unroll
  for (int j = 0; j < Fd::N; ++j) {
    dst[j] = p.x[j];
    dst[Fd::N + j] = p.y[j];
    dst[2 * Fd::N + j] = p.z[j];
  }
}

// Complete projective addition, Renes-Costello-Batina 2015 Alg. 7 (a = 0).
// The same field values as the reference's kzg/curve.py:add and
// ops/secp.py:add, so the projective output is identical bit for bit.
// r may alias p or q.
template <class Fd>
__device__ __forceinline__ void point_add(Point<Fd>& r, const Point<Fd>& p, const Point<Fd>& q) {
  constexpr int N = Fd::N;
  uint32_t t0[N], t1[N], t2[N], t3[N], t4[N], u[N], v[N];
  fmul<Fd>(t0, p.x, q.x);
  fmul<Fd>(t1, p.y, q.y);
  fmul<Fd>(t2, p.z, q.z);
  fadd<Fd>(u, p.x, p.y);
  fadd<Fd>(v, q.x, q.y);
  fmul<Fd>(t3, u, v);  // s1
  fadd<Fd>(u, t0, t1);
  fsub<Fd>(t3, t3, u);  // t3 = s1 - (t0 + t1)
  fadd<Fd>(u, p.y, p.z);
  fadd<Fd>(v, q.y, q.z);
  fmul<Fd>(t4, u, v);  // s2
  fadd<Fd>(u, t1, t2);
  fsub<Fd>(t4, t4, u);  // t4 = s2 - (t1 + t2)
  uint32_t y3[N];
  fadd<Fd>(u, p.x, p.z);
  fadd<Fd>(v, q.x, q.z);
  fmul<Fd>(y3, u, v);  // s3
  fadd<Fd>(u, t0, t2);
  fsub<Fd>(y3, y3, u);  // y3a = s3 - (t0 + t2)
  fadd<Fd>(u, t0, t0);
  fadd<Fd>(t0, u, t0);  // t0b = 3 t0
  Fd::mul_b3(u, t2);  // t2b = b3 t2
  Fd::mul_b3(v, y3);  // y3b = b3 y3a
  uint32_t z3[N];
  fadd<Fd>(z3, t1, u);  // z3a = t1 + t2b
  fsub<Fd>(t1, t1, u);  // t1b = t1 - t2b
  // X3 = t3 t1b - t4 y3b ; Y3 = t1b z3a + y3b t0b ; Z3 = z3a t4 + t0b t3
  uint32_t m0[N], m1[N];
  fmul<Fd>(m0, t4, v);
  fmul<Fd>(m1, t3, t1);
  fsub<Fd>(r.x, m1, m0);
  fmul<Fd>(m0, t1, z3);
  fmul<Fd>(m1, v, t0);
  fadd<Fd>(r.y, m0, m1);
  fmul<Fd>(m0, z3, t4);
  fmul<Fd>(m1, t0, t3);
  fadd<Fd>(r.z, m0, m1);
}

// Complete projective doubling, RCB15 Alg. 9 (a = 0); the same field
// values as the reference's double.  r may alias p.
template <class Fd>
__device__ __forceinline__ void point_double(Point<Fd>& r, const Point<Fd>& p) {
  constexpr int N = Fd::N;
  uint32_t t0[N], t1[N], t2[N], txy[N], z3[N], u[N];
  fmul<Fd>(t0, p.y, p.y);
  fmul<Fd>(t1, p.y, p.z);
  fmul<Fd>(t2, p.z, p.z);
  fmul<Fd>(txy, p.x, p.y);
  fadd<Fd>(z3, t0, t0);
  fadd<Fd>(z3, z3, z3);
  fadd<Fd>(z3, z3, z3);  // 8 Y^2
  Fd::mul_b3(t2, t2);  // t2b = b3 Z^2
  fadd<Fd>(u, t2, t2);
  fadd<Fd>(u, u, t2);  // 3 t2b
  uint32_t y3a[N];
  fadd<Fd>(y3a, t0, t2);  // y3a = t0 + t2b
  fsub<Fd>(t0, t0, u);  // t0b = t0 - 3 t2b
  // X3 = 2 t0b txy ; Y3 = t2b z3 + t0b y3a ; Z3 = t1 z3
  fmul<Fd>(u, t0, txy);
  fadd<Fd>(r.x, u, u);
  fmul<Fd>(u, t2, z3);
  fmul<Fd>(t2, t0, y3a);
  fadd<Fd>(r.y, u, t2);
  fmul<Fd>(r.z, t1, z3);
}

}  // namespace raiko
