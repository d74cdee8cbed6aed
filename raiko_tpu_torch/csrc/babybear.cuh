// BabyBear field arithmetic (p = 2^31 - 2^27 + 1) on u32 for the NTT and
// Poseidon2 kernels.
//
// Elements are Montgomery form with R = 2^32, each a u32 in [0, p): the
// layout of raiko_tpu/fields/babybear.py.  torch hands them over as int32
// tensors (p < 2^31, so the bits are the same).  Every operation returns a
// canonical value, so results equal the reference's bit for bit.
#pragma once

#include <cstdint>

namespace raiko {
namespace bb {

constexpr uint32_t P = 0x78000001u;       // 2013265921
constexpr uint32_t NPRIME = 0x77ffffffu;  // -p^-1 mod 2^32

// A value in [0, 2p) made canonical: x - p wraps above x when x < p.
__device__ __forceinline__ uint32_t canon(uint32_t x) { return min(x, x - P); }

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  return canon(a + b);  // < 2p < 2^32
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;  // wraps when a < b; adding p then lands in [0, p)
  return min(d, d + P);
}

// a * b * 2^-32 mod p.  t = a*b; m = t * (-p^-1) mod 2^32 makes t + m*p
// divisible by 2^32, and (t + m*p) / 2^32 < 2p.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * NPRIME;
  return canon((uint32_t)(((uint64_t)m * P + t) >> 32));
}

// mul(a, b) for a constant b with bn = b * (-p^-1) mod 2^32 given: m is then
// a * bn, formed beside a * b instead of after it.
__device__ __forceinline__ uint32_t mul_c(uint32_t a, uint32_t b, uint32_t bn) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = a * bn;
  return canon((uint32_t)(((uint64_t)m * P + t) >> 32));
}

}  // namespace bb
}  // namespace raiko
