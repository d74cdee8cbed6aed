// Keccak-f[1600] and Keccak-256 absorption for Hopper (sm_90a).
//
// Replaces raiko_tpu/ops/keccak.py: keccak_f1600_batch and the absorb loop
// of _keccak256_blocks (XLA in the JAX package, lax.scan over the rounds of
// a state split into u32 halves; no Pallas kernel).
//
// Layout: a state is 25 little-endian u64 lanes, lane x + 5y (the
// reference's (B, 25, 2) lo/hi u32 words read as u64); a rate block is 17
// lanes (34 words); a digest is the first 4 lanes.
//
// What bounds it on the card, and the design:
// * A permutation is 24 rounds of at least 180 32-bit instructions (LOP3
//   and funnel shifts) on 200 bytes of state, so logic operations bound it,
//   not bytes (a message of 32-532 bytes is read once and 32 bytes
//   written).  One thread owns one state and keeps its 25 lanes in
//   registers as uint64_t for every round and every block of its message:
//   the state never leaves the thread between blocks, where the reference
//   went back to device memory for each block's permutation.
// * The rho offsets and pi's lane order are derived at compile time from
//   FIPS-202 (the walk (x, y) -> (y, 2x + 3y) that utils/keccak_py.py
//   takes), so every lane index and rotation is an immediate; the round
//   constants come from the caller (utils/keccak_py.py's, as a table).
// * A batch may mix block counts: each thread absorbs its own message's
//   number of blocks in the one launch (the reference grouped messages by
//   count and launched once per group).

#include <cuda_runtime.h>

#include <cstdint>

namespace raiko {
namespace {

constexpr int kThreads = 128;

// FIPS-202 3.2.2: offset (t + 1)(t + 2) / 2 mod 64 at the t-th step of the
// walk from (1, 0); lane (0, 0) is not rotated.
__host__ __device__ constexpr int rho_offset(int x, int y) {
  int cx = 1, cy = 0;
  for (int t = 0; t < 24; ++t) {
    if (cx == x && cy == y) return ((t + 1) * (t + 2) / 2) % 64;
    const int nx = cy;
    cy = (2 * cx + 3 * cy) % 5;
    cx = nx;
  }
  return 0;
}

__device__ __forceinline__ uint64_t rotl(uint64_t v, int n) {
  return n == 0 ? v : (v << n) | (v >> (64 - n));
}

__device__ __forceinline__ void keccak_f(uint64_t (&a)[25], const uint64_t* __restrict__ rc) {
#pragma unroll 1
  for (int r = 0; r < 24; ++r) {
    uint64_t c[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d;
    }
    uint64_t b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x)
#pragma unroll
      for (int y = 0; y < 5; ++y) b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], rho_offset(x, y));
#pragma unroll
    for (int y = 0; y < 5; ++y)
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= __ldg(rc + r);
  }
}

// One thread per state.  state_in null: the zero state.  blocks null: one
// permutation.  Otherwise absorb nblocks[i] (at most max_blocks) of the
// thread's max_blocks rate blocks, each followed by a permutation.  The
// first out_lanes lanes are written.
__global__ void __launch_bounds__(kThreads)
    keccak_kernel(const uint64_t* __restrict__ state_in, uint64_t* __restrict__ state_out,
                  const uint64_t* __restrict__ blocks, const int* __restrict__ nblocks,
                  const uint64_t* __restrict__ rc, long long batch, int max_blocks, int out_lanes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  uint64_t a[25];
#pragma unroll
  for (int q = 0; q < 25; ++q) a[q] = state_in != nullptr ? state_in[i * 25 + q] : 0ull;
  if (blocks == nullptr) {
    keccak_f(a, rc);
  } else {
    const int nb = min(nblocks[i], max_blocks);
    const uint64_t* blk = blocks + i * (long long)max_blocks * 17;
    for (int t = 0; t < nb; ++t) {
#pragma unroll
      for (int q = 0; q < 17; ++q) a[q] ^= blk[t * 17 + q];
      keccak_f(a, rc);
    }
  }
#pragma unroll
  for (int q = 0; q < 25; ++q)
    if (q < out_lanes) state_out[i * out_lanes + q] = a[q];
}

}  // namespace
}  // namespace raiko

// See keccak_kernel; rc: the 24 round constants.  Pointers to lanes are
// 8-byte aligned (the wrappers check).
extern "C" int raiko_keccak_f1600(const void* state_in, void* state_out, const void* blocks,
                                  const void* nblocks, const void* rc, long long batch,
                                  int max_blocks, int out_lanes, void* stream) {
  if (out_lanes < 1 || out_lanes > 25 || (blocks != nullptr && (max_blocks < 1 || nblocks == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (batch > 0) {
    const long long grid = (batch + raiko::kThreads - 1) / raiko::kThreads;
    raiko::keccak_kernel<<<(unsigned)grid, raiko::kThreads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)state_in, (uint64_t*)state_out, (const uint64_t*)blocks,
        (const int*)nblocks, (const uint64_t*)rc, batch, max_blocks, out_lanes);
  }
  return (int)cudaGetLastError();
}
