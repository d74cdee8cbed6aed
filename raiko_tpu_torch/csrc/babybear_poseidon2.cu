// Poseidon2 over BabyBear for Hopper (sm_90a): the STARK commitment's row
// sponge (poseidon2_hash_rows) and Merkle 2-to-1 compression
// (poseidon2_compress).
//
// Counterparts of raiko_tpu/ops/poseidon2.py hash_rows and compress, which
// the JAX package leaves to XLA (there is no Pallas kernel for them): width
// 16, S-box x^7, 4 + 4 external rounds around 13 internal rounds, the M4
// circulant external layer and the sum + diag(mu) internal layer, with the
// reference's derived constants handed in by the wrapper.  Every value is
// canonical Montgomery form, so outputs equal the reference bit for bit.
//
// What bounds them on the card, and the design:
// * One permutation is 21 rounds of about 780 Montgomery products (each 4
//   32-bit multiplies) on 64 bytes of state: both kernels are bound by
//   integer multiplies, never by bytes.  At the keccak chunk's commitment
//   (4,096 rows of 4,160 columns) a row is 520 permutations in sequence.
// * One thread owns one sponge (hash_rows) or one pair (compress) and keeps
//   the 16-word state in registers; the round constants sit in shared
//   memory.  The sponge is sequential, so hash_rows has only one thread per
//   row: blocks of 32 threads spread the 4,096 rows over all 132 SMs, one
//   warp each, and the 16 independent S-boxes of a round are the
//   instruction-level parallelism that hides the multiplies' latency.
// * hash_rows reads the row matrix through two strides, so the commitment
//   hashes the rows of the LDE's transpose without a transpose: element w of
//   row i is x[i * stride_row + w * stride_col], and with stride_row = 1 a
//   warp's 32 rows read 128 contiguous bytes per column.

#include <cuda_runtime.h>

#include "babybear.cuh"

namespace raiko {
namespace {

constexpr int kWidth = 16;
constexpr int kRate = 8;
constexpr int kOut = 8;
constexpr int kRoundsF = 8;
constexpr int kRoundsP = 13;
// constants: external round constants (8 x 16), internal round constants
// (13), internal diagonal mu (16), all Montgomery
constexpr int kExtRc = 0;
constexpr int kIntRc = kRoundsF * kWidth;
constexpr int kMu = kIntRc + kRoundsP;
constexpr int kConsts = kMu + kWidth;

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint32_t x2 = bb::mul(x, x);
  const uint32_t x4 = bb::mul(x2, x2);
  const uint32_t x3 = bb::mul(x2, x);
  return bb::mul(x4, x3);
}

// M_E = circ(2 M4, M4, M4, M4): M4 [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]]
// on each group of four by the add/double chain, then each position adds
// the sum of that position over the four groups.
__device__ __forceinline__ void external_linear(uint32_t (&s)[kWidth]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const uint32_t a = s[4 * g], b = s[4 * g + 1], c = s[4 * g + 2], d = s[4 * g + 3];
    const uint32_t t0 = bb::add(a, b);
    const uint32_t t1 = bb::add(c, d);
    const uint32_t t2 = bb::add(bb::add(b, b), t1);
    const uint32_t t3 = bb::add(bb::add(d, d), t0);
    const uint32_t t1x2 = bb::add(t1, t1);
    const uint32_t t4 = bb::add(bb::add(t1x2, t1x2), t3);
    const uint32_t t0x2 = bb::add(t0, t0);
    const uint32_t t5 = bb::add(bb::add(t0x2, t0x2), t2);
    s[4 * g] = bb::add(t3, t5);
    s[4 * g + 1] = t5;
    s[4 * g + 2] = bb::add(t2, t4);
    s[4 * g + 3] = t4;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t sum = bb::add(bb::add(s[i], s[4 + i]), bb::add(s[8 + i], s[12 + i]));
#pragma unroll
    for (int g = 0; g < 4; ++g) s[4 * g + i] = bb::add(s[4 * g + i], sum);
  }
}

__device__ __forceinline__ void external_round(uint32_t (&s)[kWidth], const uint32_t* rc) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = sbox(bb::add(s[i], rc[i]));
  external_linear(s);
}

__device__ __forceinline__ void permute(uint32_t (&s)[kWidth], const uint32_t* c) {
  external_linear(s);
  for (int r = 0; r < kRoundsF / 2; ++r) external_round(s, c + kExtRc + r * kWidth);
  for (int r = 0; r < kRoundsP; ++r) {
    s[0] = sbox(bb::add(s[0], c[kIntRc + r]));
    uint32_t sum = 0;
#pragma unroll
    for (int i = 0; i < kWidth; ++i) sum = bb::add(sum, s[i]);
#pragma unroll
    for (int i = 0; i < kWidth; ++i) s[i] = bb::add(sum, bb::mul(s[i], c[kMu + i]));
  }
  for (int r = kRoundsF / 2; r < kRoundsF; ++r) external_round(s, c + kExtRc + r * kWidth);
}

__device__ __forceinline__ void load_consts(uint32_t* sm, const uint32_t* __restrict__ consts) {
  for (int i = threadIdx.x; i < kConsts; i += blockDim.x) sm[i] = consts[i];
  __syncthreads();
}

// Sponge of each row: absorb RATE elements per permutation (the last chunk
// zero-padded), the row's width (Montgomery, `width_sep`) in the last
// capacity word; the digest is the state's first OUT words.
__global__ void __launch_bounds__(32) hash_rows_kernel(const uint32_t* __restrict__ x,
                                                      uint32_t* __restrict__ out,
                                                      const uint32_t* __restrict__ consts,
                                                      long long rows, int width,
                                                      long long stride_row, long long stride_col,
                                                      uint32_t width_sep) {
  __shared__ uint32_t c[kConsts];
  load_consts(c, consts);
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  uint32_t s[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = 0;
  s[kWidth - 1] = width_sep;
  const uint32_t* src = x + row * stride_row;
  const int nchunks = width > 0 ? (width + kRate - 1) / kRate : 1;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int w0 = ch * kRate;
    if (w0 + kRate <= width) {
#pragma unroll
      for (int i = 0; i < kRate; ++i) s[i] = bb::add(s[i], src[(long long)(w0 + i) * stride_col]);
    } else {
#pragma unroll
      for (int i = 0; i < kRate; ++i)
        if (w0 + i < width) s[i] = bb::add(s[i], src[(long long)(w0 + i) * stride_col]);
    }
    permute(s, c);
  }
#pragma unroll
  for (int i = 0; i < kOut; ++i) out[row * kOut + i] = s[i];
}

// out[i] = permute(state[i])[:OUT] for contiguous (n, 16) states: the
// concatenated (left, right) digests of a Merkle level's pairs.
__global__ void __launch_bounds__(128) compress_kernel(const uint32_t* __restrict__ state,
                                                       uint32_t* __restrict__ out,
                                                       const uint32_t* __restrict__ consts,
                                                       long long n) {
  __shared__ uint32_t c[kConsts];
  load_consts(c, consts);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[kWidth];
#pragma unroll
  for (int k = 0; k < kWidth; ++k) s[k] = state[i * kWidth + k];
  permute(s, c);
#pragma unroll
  for (int k = 0; k < kOut; ++k) out[i * kOut + k] = s[k];
}

}  // namespace
}  // namespace raiko

extern "C" int raiko_poseidon2_hash_rows(const void* x, void* out, const void* consts,
                                         long long rows, int width, long long stride_row,
                                         long long stride_col, unsigned width_sep,
                                         void* stream) {
  if (rows > 0) {
    const int threads = 32;
    const long long blocks = (rows + threads - 1) / threads;
    raiko::hash_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)consts, rows, width, stride_row,
        stride_col, width_sep);
  }
  return (int)cudaGetLastError();
}

extern "C" int raiko_poseidon2_compress(const void* state, void* out, const void* consts,
                                        long long n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    raiko::compress_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)state, (uint32_t*)out, (const uint32_t*)consts, n);
  }
  return (int)cudaGetLastError();
}
