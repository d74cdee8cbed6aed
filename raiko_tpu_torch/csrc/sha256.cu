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
// What bounds it on the card, and the design (times: CUDA graphs on an
// NVIDIA H100 80GB HBM3 at 700 W, tools/time_hashes.py):
// * The function's work is at least 1,384 32-bit instructions (funnel
//   shifts, LOP3, IADD3) on a 64-byte block: integer operations bound it,
//   0.68 us at 8,192 one-block messages, 10.8 at 131,072.  Its 64 rounds
//   are one dependent chain, about four instructions a round on the e-path
//   (Sigma1's SHF and LOP3, t1's IADD3, e = d + t1) at about 4.6 clocks
//   each: 0.59 us a block.  A warp alone on a scheduler issues one logic
//   instruction every 2.06 clocks, so below a full card a lane's own
//   stream is the time, not the chain.
// * Two layouts, chosen by width and block count in ops/sha256_cuda.py:
//   - SPLIT, up to 8,192 messages of more than one block: the message
//     schedule comes off the round chain.  A block of threads is two
//     warps for 32 messages: a schedule warp expands each block's
//     W16..W63 (they depend on the block alone, never on the chaining
//     state), adds K and hands K + W to the round warp 16 words at a time
//     through a ring of four quarter-block slots in shared memory (one
//     block of schedule ahead; [word / 4][lane] 16-byte words, so a warp's
//     reads are conflict-free), synchronised by named barriers (full and
//     empty per slot).  The round warp runs the 64 rounds on K + W alone,
//     935 SASS instructions a block against one thread's 1,407 (the
//     schedule warp's about 610), and starts after the first 16 words.
//     Mixes of 0-299 bytes (one to five blocks): 8.7-9.1 us at 1,024 to
//     8,192 messages (one thread 10.9-11.1), against a 5-block chain of
//     2.9; 12.2-12.4 at 16,384 (one thread 11.0-11.2), where the crossing
//     lies.  It does not order by block count: every block of threads is
//     resident at once up to 8,192 messages, and a mix sorted by length
//     ran as fast as unsorted.
//   - THREAD, for one-block messages (where SPLIT measured the same within
//     the runs' spread) and above 8,192 messages: one thread a message,
//     the schedule in a 16-word ring of registers beside the state (the 64
//     rounds unrolled, so every ring index is an immediate; 1,407 SASS
//     instructions a block): the fewest instructions, which is what a full
//     card needs.  131,072 x 48 B: 13.7 us, 79% of the bound.  Above
//     32,768 messages of more than one block it first orders a ragged batch
//     by block count within each block of threads (order_by_count.cuh), so
//     that a warp's lanes compress the same number of blocks: 65,536 of
//     the mix 24.6 us (unordered 30.5), 131,072 47.7 (58.9).
//   Below a full card the time is mostly the launch's own (a graph's
//   one-element add takes 1.4 us) and the first loads.
// * ptxas (sm_90a): SPLIT 40 registers, THREAD 118, no spills.
// * Both compress all of a message's blocks in the one launch, the state
//   in registers between blocks.  K and H0 come from the caller (the
//   constants ops/sha256.py derives).

#include <cuda_runtime.h>

#include <cstdint>

#include "order_by_count.cuh"

// tools/time_hashes.py builds copies with RAIKO_HASH_PROFILE set: 1, THREAD
// takes the messages of a block of threads in their own order, not by block
// count.  0, the kernel, in the library.
#ifndef RAIKO_HASH_PROFILE
#define RAIKO_HASH_PROFILE 0
#endif

namespace raiko {
namespace {

constexpr int kThreads = 128;  // THREAD: messages a block of threads
constexpr int kSlots = 4;      // SPLIT: quarter-block slots in the ring
// SPLIT's named barriers: slot s is full at kFull + s, empty at kEmpty + s
// (barrier 0 is __syncthreads)
constexpr int kFull = 1, kEmpty = kFull + kSlots;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__device__ __forceinline__ uint32_t big_sigma0(uint32_t a) { return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22); }
__device__ __forceinline__ uint32_t big_sigma1(uint32_t e) { return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25); }
__device__ __forceinline__ uint32_t small_sigma0(uint32_t w) { return rotr(w, 7) ^ rotr(w, 18) ^ (w >> 3); }
__device__ __forceinline__ uint32_t small_sigma1(uint32_t w) { return rotr(w, 17) ^ rotr(w, 19) ^ (w >> 10); }

// One round on (a, ..., h) = v[0..7], kw = K[r] + W[r].
__device__ __forceinline__ void sha_round(uint32_t (&v)[8], uint32_t kw) {
  const uint32_t e = v[4], a = v[0];
  const uint32_t t1 = v[7] + big_sigma1(e) + ((e & v[5]) ^ (~e & v[6])) + kw;
  const uint32_t t2 = big_sigma0(a) + ((a & v[1]) ^ (a & v[2]) ^ (v[1] & v[2]));
  v[7] = v[6];
  v[6] = v[5];
  v[5] = e;
  v[4] = v[3] + t1;
  v[3] = v[2];
  v[2] = v[1];
  v[1] = a;
  v[0] = t1 + t2;
}

// w[r & 15] holds W[r - 16]; it becomes W[r] (16 <= r < 64).
__device__ __forceinline__ void expand(uint32_t (&w)[16], int r) {
  w[r & 15] += small_sigma0(w[(r - 15) & 15]) + w[(r - 7) & 15] + small_sigma1(w[(r - 2) & 15]);
}

// ---- THREAD: one thread a message ----------------------------------------------

__device__ __forceinline__ void compress(uint32_t (&s)[8], const uint32_t* __restrict__ block,
                                         const uint32_t* __restrict__ k) {
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) w[q] = block[q];
  uint32_t v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = s[q];
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    if (r >= 16) expand(w, r);
    sha_round(v, __ldg(k + r) + w[r & 15]);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) s[q] += v[q];
}

// From state_in (H0 where null), compress nblocks[i] (at most max_blocks)
// of message i's max_blocks blocks; kOrdered (for max_blocks > 1, above
// kOrderAbove messages): the messages of a block of threads taken in order
// of their counts.
template <bool kOrdered>
__global__ void __launch_bounds__(kThreads)
    sha256_thread_kernel(const uint32_t* __restrict__ state_in, uint32_t* __restrict__ state_out,
                         const uint32_t* __restrict__ blocks, const int* __restrict__ nblocks,
                         const uint32_t* __restrict__ kh, long long batch, int max_blocks) {
  const long long first = (long long)blockIdx.x * kThreads;
  long long i = first + threadIdx.x;
  if constexpr (kOrdered) i = first + order_by_count<kThreads>(nblocks, first, batch, max_blocks, threadIdx.x);
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

// ---- SPLIT: a schedule warp and a round warp for 32 messages ------------------

__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory"); }

// Warp 0 writes K + W of each block of its lane's message into the ring, a
// quarter (16 words) a slot; warp 1 runs the rounds on them.  Both warps
// walk the most blocks any of the 32 messages has, so their barriers pair
// up; a message past its own count computes and discards.
__global__ void __launch_bounds__(64)
    sha256_split_kernel(const uint32_t* __restrict__ state_in, uint32_t* __restrict__ state_out,
                        const uint32_t* __restrict__ blocks, const int* __restrict__ nblocks,
                        const uint32_t* __restrict__ kh, long long batch, int max_blocks) {
  __shared__ uint4 ring[kSlots][4][32];  // [slot][word / 4][lane]
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * 32 + lane;
  const int nb = i < batch ? max(0, min(nblocks[i], max_blocks)) : 0;
  const int nmax = __reduce_max_sync(0xffffffffu, nb);
  if (threadIdx.x < 32) {
    const uint32_t* blk = blocks + i * (long long)max_blocks * 16;
    for (int t = 0; t < nmax; ++t) {
      uint32_t w[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) w[q] = t < nb ? blk[t * 16 + q] : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // quarter j of block t goes to slot j
        if (j > 0) {
#pragma unroll
          for (int q = 0; q < 16; ++q) expand(w, 16 * j + q);
        }
        if (t > 0) bar_sync(kEmpty + j);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ring[j][q][lane] = make_uint4(__ldg(kh + 16 * j + 4 * q) + w[4 * q], __ldg(kh + 16 * j + 4 * q + 1) + w[4 * q + 1],
                                        __ldg(kh + 16 * j + 4 * q + 2) + w[4 * q + 2],
                                        __ldg(kh + 16 * j + 4 * q + 3) + w[4 * q + 3]);
        bar_arrive(kFull + j);
      }
    }
  } else {
    uint32_t s[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) s[q] = i < batch && state_in != nullptr ? state_in[i * 8 + q] : __ldg(kh + 64 + q);
    for (int t = 0; t < nmax; ++t) {
      uint32_t v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = s[q];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bar_sync(kFull + j);
        uint32_t kw[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 x = ring[j][q][lane];
          kw[4 * q] = x.x, kw[4 * q + 1] = x.y, kw[4 * q + 2] = x.z, kw[4 * q + 3] = x.w;
        }
        if (t + 1 < nmax) bar_arrive(kEmpty + j);  // the schedule warp waits on it for block t + 1
#pragma unroll
        for (int q = 0; q < 16; ++q) sha_round(v, kw[q]);
      }
      if (t < nb) {
#pragma unroll
        for (int q = 0; q < 8; ++q) s[q] += v[q];
      }
    }
    if (i < batch) {
#pragma unroll
      for (int q = 0; q < 8; ++q) state_out[i * 8 + q] = s[q];
    }
  }
}

}  // namespace
}  // namespace raiko

// See the kernels; kh: K (64 words) then H0 (8 words); split: 1 for SPLIT,
// 0 for THREAD.
extern "C" int raiko_sha256_compress(const void* state_in, void* state_out, const void* blocks,
                                     const void* nblocks, const void* kh, long long batch,
                                     int max_blocks, int split, void* stream) {
  if (max_blocks < 1 || nblocks == nullptr) return (int)cudaErrorInvalidValue;
  if (batch > 0) {
    const long long per_block = split ? 32 : raiko::kThreads;
    const unsigned grid = (unsigned)((batch + per_block - 1) / per_block);
    const auto kernel = split ? raiko::sha256_split_kernel
                        : max_blocks > 1 && batch > raiko::kOrderAbove && !(RAIKO_HASH_PROFILE & 1)
                            ? raiko::sha256_thread_kernel<true>
                                         : raiko::sha256_thread_kernel<false>;
    kernel<<<grid, split ? 64 : raiko::kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)state_in, (uint32_t*)state_out, (const uint32_t*)blocks, (const int*)nblocks,
        (const uint32_t*)kh, batch, max_blocks);
  }
  return (int)cudaGetLastError();
}
