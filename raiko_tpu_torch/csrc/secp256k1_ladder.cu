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
// formulas are the reference's complete RCB15 ones with b3 = 21.
//
// What bounds it on the card, and the design: each signature is a serial
// chain of 256 doublings and additions, and a block has 101-128 of them,
// so the card is bound by the latency of the chain's dependent field
// operations, not by any throughput.  One thread per signature would run
// an iteration's 20 Montgomery products one after another, and 128
// signatures would fill 2 of the 132 SMs (9.9 ms on an H100).  So one
// warp runs one signature (field32_coop.cuh): a field element is spread
// over a group of 8 lanes, one limb per lane, so a product is 8
// shuffle-linked CIOS steps, and carries resolve through ballots.  The four
// groups of the warp split each layer of independent products (doubling:
// two layers of 4, one per group; addition: two layers of 6, two per lane),
// so an iteration has 4 dependent product layers; one warp per block puts
// each signature on its own SM up to 132.  Every group holds the table
// entries T1, T2, T1 + T2; the select stays a masked copy.  The 256 window
// indices are read once, packed two bits each into 16 bits of each lane,
// and reach the iteration by a shuffle.  The field operations are
// field32.cuh's, in its order, and each result is canonical, so the output
// equals the plain version (ops/secp.py:_shamir) bit for bit.  ptxas (nvcc
// 12.9, sm_90a, -O3): 50 registers, no spills.  On an H100 80GB HBM3 (700 W
// limit) 128 signatures took 1.41 ms, 5.5 us per iteration, and 101 the
// same: each chain has its SM, and its latency bounds it.

#include <cuda_runtime.h>

#include "field32_coop.cuh"

namespace raiko {

__constant__ uint32_t kSecpP[8] = {0xfffffc2fu, 0xfffffffeu, 0xffffffffu, 0xffffffffu,
                                   0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
// R mod p, the Montgomery form of 1
__constant__ uint32_t kSecpOne[8] = {0x000003d1u, 0x00000001u, 0u, 0u, 0u, 0u, 0u, 0u};

struct SecpFp {
  static constexpr int N = 8;
  static constexpr uint32_t NP0 = 0xd2253531u;  // -p^-1 mod 2^32
  static constexpr uint32_t B3 = 21;
  __device__ static __forceinline__ uint32_t p(int i) { return kSecpP[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return kSecpOne[i]; }
};

// ---- kernel ------------------------------------------------------------

// One warp per signature: block b runs lane b's ladder.
__global__ void __launch_bounds__(32) shamir_ladder_kernel(const uint32_t* __restrict__ base,
                                                           const int32_t* __restrict__ idx,
                                                           uint32_t* __restrict__ out,
                                                           long long batch) {
  using L = Lanes<SecpFp, 8>;
  const L lanes;
  const long long b = blockIdx.x;
  const CPoint t1 = c_load(lanes, base + b * 48);
  const CPoint t2 = c_load(lanes, base + b * 48 + 24);
  const CPoint t3 = c_point_add(lanes, t1, t2);
  // lane l packs the indices of iterations 8l..8l+7, two bits each
  const uint32_t lane = threadIdx.x & 31u;
  uint32_t packed = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) packed |= ((uint32_t)idx[(8 * lane + q) * batch + b] & 3u) << (2 * q);
  const uint32_t one = SecpFp::one(lanes.j);
  CPoint acc = {0u, one, 0u};
  for (int k = 0; k < 256; ++k) {
    acc = c_double(lanes, acc);
    const uint32_t e = (__shfl_sync(kFullMask, packed, k >> 3) >> (2 * (k & 7))) & 3u;
    const uint32_t m1 = 0u - (uint32_t)(e == 1), m2 = 0u - (uint32_t)(e == 2);
    const uint32_t m3 = 0u - (uint32_t)(e == 3), m0 = 0u - (uint32_t)(e == 0);
    const CPoint add = {(t1.x & m1) | (t2.x & m2) | (t3.x & m3),
                        (t1.y & m1) | (t2.y & m2) | (t3.y & m3) | (one & m0),
                        (t1.z & m1) | (t2.z & m2) | (t3.z & m3)};
    acc = c_point_add(lanes, acc, add);
  }
  c_store(lanes, out + b * 24, acc);
}

}  // namespace raiko

extern "C" int raiko_secp256k1_shamir_ladder(const void* base, const void* idx, void* out,
                                             long long batch, void* stream) {
  if (batch > 0) {
    raiko::shamir_ladder_kernel<<<(unsigned)batch, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)base, (const int32_t*)idx, (uint32_t*)out, batch);
  }
  return (int)cudaGetLastError();
}
