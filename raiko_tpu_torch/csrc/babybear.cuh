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

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2p < 2^32
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + P - b;
}

// a * b * 2^-32 mod p.  t = a*b = hi:lo; m = lo * (-p^-1) mod 2^32 makes
// t + m*p divisible by 2^32, and the low words of t and m*p sum to 0 or
// 2^32 (a carry of 1 exactly when lo != 0); (t + m*p) / 2^32 < 2p.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  const uint32_t lo = a * b;
  const uint32_t hi = __umulhi(a, b);
  const uint32_t m = lo * NPRIME;
  const uint32_t r = hi + __umulhi(m, P) + (lo != 0u ? 1u : 0u);
  return r >= P ? r - P : r;
}

}  // namespace bb
}  // namespace raiko
