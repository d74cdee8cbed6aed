// secp256k1 Shamir double-scalar ladder for Hopper (sm_90a): kernel B4 of
// batched ECDSA sender recovery.
//
// Replaces raiko_tpu/ops/secp_pallas.py: shamir_ladder (kernel
// _ladder_kernel), together with the window-table completion that
// raiko_tpu/ops/secp.py:_recover_launch_tpu ran in XLA before it.
//
// Per lane b, with base points T1 = base[b, 0] and T2 = base[b, 1]:
//   table = [inf, T1, T2, T1 + T2]
//   acc = inf; for k in 0..255: acc = 2 acc + table[idx[k, b]]
// where idx[k, b] = bit (255-k) of u1 + 2 * bit (255-k) of u2.  Points are
// (3, 8) little-endian 32-bit limbs in Montgomery form with R = 2^256; the
// formulas are the reference's complete RCB15 ones with b3 = 21, so the
// output equals ops/secp.py:_shamir bit for bit.
//
// What bounds it on the card, and the design: each lane is a serial chain
// of 256 doublings and additions (about 6,000 dependent 32-bit multiplies
// per iteration), and a block has a few hundred lanes at most, so the card
// is latency-bound and mostly idle.  One thread per lane keeps the
// accumulator and the three non-trivial table entries in registers; the
// 4-way window select is a masked copy (no dynamic register indexing, so
// nothing goes to local memory); the per-iteration index is one coalesced
// 32-bit load from the (256, B) index array.  Lanes past B return early,
// so no padding lanes are launched.  ptxas (nvcc 12.9, sm_90a, -O3): 220
// registers, no spills.  On an H100 80GB HBM3 (700 W limit), 128 lanes
// took 9.86 ms: two blocks, so two of the 132 SMs work.

#include <cuda_runtime.h>

#include "field32.cuh"

namespace raiko {

__constant__ uint32_t kSecpP[8] = {0xfffffc2fu, 0xfffffffeu, 0xffffffffu, 0xffffffffu,
                                   0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
// R mod p, the Montgomery form of 1
__constant__ uint32_t kSecpOne[8] = {0x000003d1u, 0x00000001u, 0u, 0u, 0u, 0u, 0u, 0u};

struct SecpFp {
  static constexpr int N = 8;
  static constexpr uint32_t NP0 = 0xd2253531u;  // -p^-1 mod 2^32
  __device__ static __forceinline__ uint32_t p(int i) { return kSecpP[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return kSecpOne[i]; }
  // b3 = 3 * 7 = 21: 21a = 16a + 4a + a.  r may alias a.
  __device__ static __forceinline__ void mul_b3(uint32_t (&r)[N], const uint32_t (&a)[N]) {
    uint32_t a4[N], a16[N];
    fadd<SecpFp>(a4, a, a);
    fadd<SecpFp>(a4, a4, a4);
    fadd<SecpFp>(a16, a4, a4);
    fadd<SecpFp>(a16, a16, a16);
    fadd<SecpFp>(a16, a16, a4);
    fadd<SecpFp>(r, a16, a);
  }
};

using SecpPoint = Point<SecpFp>;

// ---- kernels -----------------------------------------------------------

__device__ __forceinline__ void select_entry(SecpPoint& out, int e, const SecpPoint& t1,
                                             const SecpPoint& t2, const SecpPoint& t3) {
  const uint32_t m1 = 0u - (uint32_t)(e == 1);
  const uint32_t m2 = 0u - (uint32_t)(e == 2);
  const uint32_t m3 = 0u - (uint32_t)(e == 3);
  const uint32_t m0 = 0u - (uint32_t)(e == 0);
#pragma unroll
  for (int j = 0; j < SecpFp::N; ++j) {
    out.x[j] = (t1.x[j] & m1) | (t2.x[j] & m2) | (t3.x[j] & m3);
    out.y[j] = (t1.y[j] & m1) | (t2.y[j] & m2) | (t3.y[j] & m3) | (SecpFp::one(j) & m0);
    out.z[j] = (t1.z[j] & m1) | (t2.z[j] & m2) | (t3.z[j] & m3);
  }
}

__global__ void __launch_bounds__(64) shamir_ladder_kernel(const uint32_t* __restrict__ base,
                                                           const int32_t* __restrict__ idx,
                                                           uint32_t* __restrict__ out,
                                                           long long batch) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  SecpPoint t1, t2, t3, acc, add;
  load_point(t1, base + b * 48);
  load_point(t2, base + b * 48 + 24);
  point_add(t3, t1, t2);
  set_identity(acc);
  for (int k = 0; k < 256; ++k) {
    point_double(acc, acc);
    select_entry(add, idx[(long long)k * batch + b], t1, t2, t3);
    point_add(acc, acc, add);
  }
  store_point(out + b * 24, acc);
}

}  // namespace raiko

extern "C" int raiko_secp256k1_shamir_ladder(const void* base, const void* idx, void* out,
                                             long long batch, void* stream) {
  if (batch > 0) {
    const int threads = 64;
    const long long blocks = (batch + threads - 1) / threads;
    raiko::shamir_ladder_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)base, (const int32_t*)idx, (uint32_t*)out, batch);
  }
  return (int)cudaGetLastError();
}
