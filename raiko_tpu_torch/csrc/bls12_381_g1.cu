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
//   products of 12 x 12 limbs (about 3,500 32-bit multiply-adds with the
//   reductions) against 432 bytes moved.  One thread owns one pair of
//   points and keeps every coordinate and temporary in registers; blocks of
//   128 threads tile M, so the 131,072-wide adds of a blob MSM fill all 132
//   SMs.  Register pressure is the limit on occupancy: ptxas (nvcc 12.9,
//   sm_90a, -O3) gives ec_add_kernel 186 registers and weighted_fold_kernel
//   193, with no spills, so an SM holds two 128-thread blocks (8 of its 64
//   warps).  The build log beside the library keeps the report.  On an H100
//   80GB HBM3 (700 W limit) one launch at M = 131,072 took 0.289 ms, moving
//   57 MB (about 6% of HBM bandwidth): the integer multiplies bound it.
// * B2 is a serial chain of 255 doublings and additions per batch entry.
//   One thread per entry, grid over entries, so any batch size runs (the
//   Pallas version staged the whole batch in one VMEM block and failed
//   above about 170 entries).  At batch 1 a single thread runs the chain
//   and the card is nearly idle; it is bound by the latency of dependent
//   multiplies (19.6 ms per fold on the H100 above).  Splitting the chain
//   across threads is later work.
// * B3 is B1's shape with RCB15 Alg. 9: 8 CIOS products per point against
//   288 bytes moved, so integer multiplies bound it too.  One thread per
//   point, point_double of field32.cuh (the doubling B2 runs).
// The Pallas kernels' TPU layout (limbs on sublanes, six products stacked
// along lanes, deferred Kogge-Stone carries) does not carry over: a thread's
// registers hold whole field elements and carries ripple through 64-bit
// intermediates.

#include <cuda_runtime.h>

#include "field32.cuh"

namespace raiko {

__constant__ uint32_t kBlsP[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

struct BlsFp {
  static constexpr int N = 12;
  static constexpr uint32_t NP0 = 0xfffcfffdu;  // -p^-1 mod 2^32
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

using G1 = Point<BlsFp>;

// ---- kernels -----------------------------------------------------------

__global__ void __launch_bounds__(128) ec_add_kernel(const uint32_t* __restrict__ p,
                                                     const uint32_t* __restrict__ q,
                                                     uint32_t* __restrict__ out, long long m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  G1 a, b;
  load_point(a, p + i * 36);
  load_point(b, q + i * 36);
  point_add(a, a, b);
  store_point(out + i * 36, a);
}

__global__ void __launch_bounds__(128) ec_double_kernel(const uint32_t* __restrict__ p,
                                                        uint32_t* __restrict__ out, long long m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  G1 a;
  load_point(a, p + i * 36);
  point_double(a, a);
  store_point(out + i * 36, a);
}

// out[b] = sum_j 2^j v[b, j] as acc = v[J-1]; acc = 2 acc + v[j] for j = J-2..0.
__global__ void __launch_bounds__(64) weighted_fold_kernel(const uint32_t* __restrict__ v,
                                                           uint32_t* __restrict__ out,
                                                           long long batch, int j) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uint32_t* row = v + b * (long long)j * 36;
  G1 acc, t;
  load_point(acc, row + (long long)(j - 1) * 36);
  for (int k = j - 2; k >= 0; --k) {
    point_double(acc, acc);
    load_point(t, row + (long long)k * 36);
    point_add(acc, acc, t);
  }
  store_point(out + b * 36, acc);
}

}  // namespace raiko

extern "C" int raiko_bls12_381_ec_add(const void* p, const void* q, void* out, long long m,
                                      void* stream) {
  if (m > 0) {
    const int threads = 128;
    const long long blocks = (m + threads - 1) / threads;
    raiko::ec_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, m);
  }
  return (int)cudaGetLastError();
}

extern "C" int raiko_bls12_381_ec_double(const void* p, void* out, long long m, void* stream) {
  if (m > 0) {
    const int threads = 128;
    const long long blocks = (m + threads - 1) / threads;
    raiko::ec_double_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)out, m);
  }
  return (int)cudaGetLastError();
}

extern "C" int raiko_bls12_381_weighted_fold(const void* v, void* out, long long batch, int j,
                                             void* stream) {
  if (batch > 0) {
    const int threads = 64;
    const long long blocks = (batch + threads - 1) / threads;
    raiko::weighted_fold_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)v, (uint32_t*)out, batch, j);
  }
  return (int)cudaGetLastError();
}
