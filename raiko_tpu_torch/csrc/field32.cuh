// Montgomery field arithmetic over 32-bit limbs, one field element per
// thread, and the complete short-Weierstrass (a = 0) doubling: kernel B1
// runs these products and sums per lane (bls12_381_g1.cu), B3 the doubling
// per thread.  The serial chains B2 and B4 run the same operations spread
// over a warp (field32_coop.cuh).
//
// A field element is N little-endian 32-bit limbs held in registers.  The
// Montgomery radix is R = 2^(32N), which equals the public layout's
// 2^(16 * 2N), so Montgomery values match the 16-bit-limb reference bit for
// bit.  Every operation returns a canonical value in [0, p).
//
// The carries run in PTX carry chains (add.cc / addc, sub.cc / subc,
// mad.lo.cc / madc.hi.cc), one instruction per limb and no 64-bit
// temporaries: a CIOS product is 4N + 7 instructions per limb of b, 2N + 1
// of them multiplies.  With them one thread per B1 addition went from 186
// to 168 registers and from 0.28 to 0.23 ms at 131,072 pairs on an H100
// (PERF.md), before B1 moved to a group of lanes per pair.
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

// ---- carry chains ----------------------------------------------------------
// One PTX instruction each.  The carry flag links consecutive calls: a chain
// is a run of these with nothing between them that sets the flag (the
// compiler's own code never does), and asm volatile keeps their order.
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// c + the low or high word of a b, with (madc) and without (mad) the carry in
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// r = t - p if (top != 0 or t >= p) else t, for t + top * 2^(32N) < 2p.
// r may alias t.
template <class Fd>
__device__ __forceinline__ void reduce_once(uint32_t (&r)[Fd::N], const uint32_t (&t)[Fd::N],
                                            uint32_t top) {
  constexpr int N = Fd::N;
  uint32_t d[N];
  d[0] = sub_cc(t[0], Fd::p(0));
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = subc_cc(t[j], Fd::p(j));
  // top - borrow is all ones exactly when top == 0 and t < p
  const bool keep = subc(top, 0) == 0xffffffffu;
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = keep ? t[j] : d[j];
}

template <class Fd>
__device__ __forceinline__ void fadd(uint32_t (&r)[Fd::N], const uint32_t (&a)[Fd::N],
                                     const uint32_t (&b)[Fd::N]) {
  constexpr int N = Fd::N;
  uint32_t s[N];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) s[j] = addc_cc(a[j], b[j]);
  const uint32_t carry = addc(0, 0);
  reduce_once<Fd>(r, s, carry);
}

template <class Fd>
__device__ __forceinline__ void fsub(uint32_t (&r)[Fd::N], const uint32_t (&a)[Fd::N],
                                     const uint32_t (&b)[Fd::N]) {
  constexpr int N = Fd::N;
  uint32_t d[N];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = subc_cc(a[j], b[j]);
  // on borrow add p back; the carry out of that add cancels the borrow
  const uint32_t mask = subc(0, 0);
  r[0] = add_cc(d[0], Fd::p(0) & mask);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) r[j] = addc_cc(d[j], Fd::p(j) & mask);
  r[N - 1] = addc(d[N - 1], Fd::p(N - 1) & mask);
}

// CIOS Montgomery product a * b * R^-1 mod p, inputs in [0, p).  Each step
// adds a b_i and then m p (m = t_0 NP0 mod 2^32, so limb 0 becomes 0) to the
// accumulator t < 2p, each as two carry chains (the low words of the limb
// products into limbs j, the high words into limbs j + 1), and shifts t
// down one limb.  4N + 7 instructions per step, 2N^2 + N of them IMADs.
template <class Fd>
__device__ __forceinline__ void fmul(uint32_t (&r)[Fd::N], const uint32_t (&a)[Fd::N],
                                     const uint32_t (&b)[Fd::N]) {
  constexpr int N = Fd::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = b[i];
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) t[j] = a[j] * bi;
      t[1] = mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
      for (int j = 1; j < N - 1; ++j) t[j + 1] = madc_hi_cc(a[j], bi, t[j + 1]);
      t[N] = madc_hi(a[N - 1], bi, 0);
      t[N + 1] = 0;
    } else {
      t[0] = mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
      for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(a[j], bi, t[j]);
      t[N] = addc_cc(t[N], 0);
      t[N + 1] = addc(0, 0);
      t[1] = mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
      for (int j = 1; j < N; ++j) t[j + 1] = madc_hi_cc(a[j], bi, t[j + 1]);
      t[N + 1] = addc(t[N + 1], 0);
    }
    const uint32_t m = t[0] * Fd::NP0;
    t[0] = mad_lo_cc(m, Fd::p(0), t[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(m, Fd::p(j), t[j]);
    t[N] = addc_cc(t[N], 0);
    t[N + 1] = addc(t[N + 1], 0);
    t[1] = mad_hi_cc(m, Fd::p(0), t[1]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j + 1] = madc_hi_cc(m, Fd::p(j), t[j + 1]);
    t[N + 1] = addc(t[N + 1], 0);
#pragma unroll
    for (int j = 0; j <= N; ++j) t[j] = t[j + 1];
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
