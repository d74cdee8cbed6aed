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
//   points and keeps every coordinate and temporary in registers
//   (field32.cuh); blocks of 128 threads tile M, so the 131,072-wide adds
//   of a blob MSM fill all 132 SMs.  Register pressure is the limit on
//   occupancy: ptxas (nvcc 12.9, sm_90a, -O3) gives ec_add_kernel 186
//   registers with no spills, so an SM holds two 128-thread blocks.  The
//   build log beside the library keeps the report.  On an H100 80GB HBM3
//   (700 W limit) one launch at M = 131,072 took 0.28 ms: the integer
//   multiplies bound it.
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
// * B3 is B1's shape with RCB15 Alg. 9: 8 CIOS products per point against
//   288 bytes moved, so integer multiplies bound it too.  One thread per
//   point, point_double of field32.cuh.
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
    raiko::weighted_fold_kernel<<<(unsigned)batch, 32, 0, (cudaStream_t)stream>>>((const uint32_t*)v,
                                                                                (uint32_t*)out, j);
  }
  return (int)cudaGetLastError();
}
