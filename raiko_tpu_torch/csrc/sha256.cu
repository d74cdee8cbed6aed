// SHA-256 compression for Hopper (sm_90a).
//
// Replaces raiko_tpu/ops/sha256.py: sha256_compress_batch and the block
// loop of _sha256_blocks (XLA in the JAX package: the schedule as a
// vectorised unroll, the 64 rounds under lax.scan; no Pallas kernel).
//
// Layout: a state is 8 u32 words, a block 16 big-endian message words
// already read as u32 values (the reference's layout; the wrappers pass
// torch int32 tensors that carry the bits).
//
// What bounds it on the card, and the design:
// * A compression is at least 1,384 32-bit instructions (funnel shifts,
//   LOP3, IADD3) on a 64-byte block, so integer operations bound it, not
//   bytes.  One thread
//   owns one message: its state and a 16-word ring of the schedule stay in
//   registers (the loop over the 64 rounds is unrolled, so every ring index
//   is an immediate), and it compresses all of its message's blocks in the
//   one launch, where the reference went back to device memory between
//   blocks and grouped the batch by block count.
// * K and H0 come from the caller (the constants ops/sha256.py derives).

#include <cuda_runtime.h>

#include <cstdint>

namespace raiko {
namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

__device__ __forceinline__ void compress(uint32_t (&s)[8], const uint32_t* __restrict__ block,
                                         const uint32_t* __restrict__ k) {
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) w[q] = block[q];
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    if (r >= 16) {  // w[r & 15] holds w_{r-16}
      const uint32_t w15 = w[(r - 15) & 15], w2 = w[(r - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[r & 15] += s0 + w[(r - 7) & 15] + s1;
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) +
                        __ldg(k + r) + w[r & 15];
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
  s[4] += e;
  s[5] += f;
  s[6] += g;
  s[7] += h;
}

// One thread per message: from state_in (H0 where null), compress
// nblocks[i] (at most max_blocks) of its max_blocks blocks.
__global__ void __launch_bounds__(kThreads)
    sha256_kernel(const uint32_t* __restrict__ state_in, uint32_t* __restrict__ state_out,
                  const uint32_t* __restrict__ blocks, const int* __restrict__ nblocks,
                  const uint32_t* __restrict__ kh, long long batch, int max_blocks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  uint32_t s[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) s[q] = state_in != nullptr ? state_in[i * 8 + q] : __ldg(kh + 64 + q);
  const int nb = min(nblocks[i], max_blocks);
  const uint32_t* blk = blocks + i * (long long)max_blocks * 16;
  for (int t = 0; t < nb; ++t) compress(s, blk + t * 16, kh);
#pragma unroll
  for (int q = 0; q < 8; ++q) state_out[i * 8 + q] = s[q];
}

}  // namespace
}  // namespace raiko

// See sha256_kernel; kh: K (64 words) then H0 (8 words).
extern "C" int raiko_sha256_compress(const void* state_in, void* state_out, const void* blocks,
                                     const void* nblocks, const void* kh, long long batch,
                                     int max_blocks, void* stream) {
  if (max_blocks < 1 || nblocks == nullptr) return (int)cudaErrorInvalidValue;
  if (batch > 0) {
    const long long grid = (batch + raiko::kThreads - 1) / raiko::kThreads;
    raiko::sha256_kernel<<<(unsigned)grid, raiko::kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)state_in, (uint32_t*)state_out, (const uint32_t*)blocks,
        (const int*)nblocks, (const uint32_t*)kh, batch, max_blocks);
  }
  return (int)cudaGetLastError();
}
