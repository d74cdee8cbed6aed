// Keccak-f[1600] and Keccak-256 absorption for Hopper (sm_90a).
//
// Replaces raiko_tpu/ops/keccak.py: keccak_f1600_batch and the absorb loop
// of _keccak256_blocks (XLA in the JAX package, lax.scan over the rounds of
// a state split into u32 halves; no Pallas kernel).
//
// Layout outside the kernel: a state is 25 little-endian u64 lanes, lane
// x + 5y (the reference's (B, 25, 2) lo/hi u32 words); a rate block is 17
// lanes (34 words); a digest is the first 4 lanes.
//
// What bounds it on the card, and the design (times: CUDA graphs on an
// NVIDIA H100 80GB HBM3 at 700 W, tools/time_hashes.py):
// * The function's work is 24 rounds of 180 32-bit logic instructions
//   (LOP3, funnel shifts) on 200 bytes of state: logic operations bound
//   it, 2.1 us at 8,192 states, 33.9 at 131,072.  A scheduler's logic unit
//   takes 16 lanes a clock, so a warp alone on a scheduler issues a LOP3
//   every 2.06 clocks (the probe); a dependent LOP3 or SHF waits 4.6
//   clocks, a SHFL 24.5, and a lone warp issues a SHFL every 4.07.  One
//   thread a state gives 256 warps at 8,192 states, under half of the 528
//   schedulers, each running its whole stream alone.
// * A permutation runs on a pair of lanes a state, by bit interleaving:
//   the even lane keeps the even bits of the 25 lanes as 32-bit words, the
//   odd lane the odd bits.  Theta's parities, chi and iota are 32-bit
//   operations on a lane's own words; a rotation by 2k rotates each half by
//   k; one by 2k + 1 swaps the halves (the even lane takes rotl32(odd,
//   k + 1), the odd lane rotl32(even, k)): one shfl.xor and one funnel
//   shift by an amount held per lane parity.  A round is 117.5 SASS
//   instructions a lane (68 LOP3, 29 SHF, 17 SHFL; two rounds a loop
//   iteration) against one thread's 200 (136 LOP3, 58 SHF), twice the
//   warps at 0.59 of the stream each; stamped, a round ran 241 clocks at
//   8,192 states, its issue rate (the shuffles overlap the logic: with them
//   replaced by local moves it ran the same, and the call 3% faster).  A
//   block's 64 states pass through shared memory, so that global memory is
//   read and written in whole lines; read in place (the (B, 25, 2) layout
//   puts a warp's 16 states 200 bytes apart) loading took 0.94 us and
//   storing 2.5 of a 7.6 us span.  States are interleaved after the load
//   and de-interleaved before the store (three delta swaps and a byte
//   permutation a word, one exchange a lane).  8,192 states: 7.05 us (read
//   in place 10.2, one thread 12.5), 30% of the bound, over a graph
//   launch's floor of 1.3-1.5 us; 131,072: 63.7 (72.0, 80.6), 53%.
// * Absorbing has two layouts (LANES), chosen in ops/keccak_cuda.py: the
//   pair up to 8,192 messages, one thread a state, its 25 lanes in
//   registers as uint64, above (8,192 nodes of 32-532 bytes: the pair
//   17.9 us, one thread 23.3; 16,384: the pair 28.2, one thread 22.7).
//   Each thread (or pair) takes its own message's number of blocks, with
//   the state in registers between blocks and the next block's loads in
//   flight during a permutation.  The warp stays converged (the exchanges
//   are whole-warp shuffles): a pair past the batch computes on the last
//   message and stores nothing, and the warp walks its longest message,
//   each state storing after its own last block.  A warp runs as long as
//   its longest message, so a block of threads first orders its messages
//   by block count (order_by_count.cuh), the pair at every width (2-4%
//   faster at 8,192 and 16,384 messages, 15-21% from 32,768), one thread a
//   message above 32,768 (17% faster from 65,536; up to 32,768 ordering
//   cost it 2-4%); every digest is written at its caller's index.  131,072
//   nodes: 135 us (unordered 162.5), 65% of the bound.
// * ptxas (sm_90a): the pair 56 registers and 12,800 bytes of shared
//   memory permuting, 80 registers absorbing; one thread 116; no spills.
// * The rho offsets and pi's lane order are derived at compile time from
//   FIPS-202 (the walk (x, y) -> (y, 2x + 3y) that utils/keccak_py.py
//   takes), so every lane index and rotation is an immediate; the round
//   constants come from the caller, as (lo, hi) words for LANES = 1 and as
//   (even, odd) interleaved words for LANES = 2.

#include <cuda_runtime.h>

#include <cstdint>

#include "order_by_count.cuh"

// tools/time_hashes.py builds copies with RAIKO_HASH_PROFILE set, its bits:
// 1, the messages of a block of threads taken in their own order, not by
// block count; 2, each exchange of the pair's round replaced by a local
// byte permutation (wrong states); 4, lanes 0 and 1 of a warp write stamps
// of their permutation over the (lo, hi) words of their state's lanes 0-2
// (see permute_pair_block).  0, the kernel, in the library.
#ifndef RAIKO_HASH_PROFILE
#define RAIKO_HASH_PROFILE 0
#endif

namespace raiko {
namespace {

constexpr int kThreads = 128;
constexpr int kProfile = RAIKO_HASH_PROFILE;

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

// ---- one thread a state ---------------------------------------------------

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

// ---- a pair of lanes a state, bit-interleaved ------------------------------

// The even bits of x in its low half, the odd bits in its high half.
__device__ __forceinline__ uint32_t unzip(uint32_t x) {
  uint32_t t;
  t = (x ^ (x >> 1)) & 0x22222222u, x ^= t ^ (t << 1);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu, x ^= t ^ (t << 2);
  t = (x ^ (x >> 4)) & 0x00F000F0u, x ^= t ^ (t << 4);
  return __byte_perm(x, 0, 0x3120);
}

// The inverse of unzip.
__device__ __forceinline__ uint32_t zip(uint32_t x) {
  uint32_t t;
  x = __byte_perm(x, 0, 0x3120);
  t = (x ^ (x >> 4)) & 0x00F000F0u, x ^= t ^ (t << 4);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu, x ^= t ^ (t << 2);
  t = (x ^ (x >> 1)) & 0x22222222u, x ^= t ^ (t << 1);
  return x;
}

// What a lane of a pair needs: the byte selector that joins its half with
// its partner's (0x5410 on the even lane: the low halves; 0x3276 on the odd
// lane: the high halves), and `up`, 1 on the even lane, which takes
// rotl32(odd, k + 1) where the odd lane takes rotl32(even, k).  Every
// exchange is a shuffle of the whole warp, which stays converged (a mask
// held in a register would make each one a convergence check).
struct PairLane {
  uint32_t sel, up;
};

// The lane's interleaved half of the 64-bit lane whose (lo, hi) word it
// holds as `word` (lo on the even lane, hi on the odd).
__device__ __forceinline__ uint32_t interleave(uint32_t word, const PairLane& p) {
  const uint32_t u = unzip(word);
  return __byte_perm(u, __shfl_xor_sync(0xffffffffu, u, 1), p.sel);
}

// The inverse: the lane's (lo, hi) word of the 64-bit lane whose
// interleaved half it holds.
__device__ __forceinline__ uint32_t deinterleave(uint32_t half, const PairLane& p) {
  return zip(__byte_perm(half, __shfl_xor_sync(0xffffffffu, half, 1), p.sel));
}

// rotl64 by N of the lane this lane holds half of.
template <int N>
__device__ __forceinline__ uint32_t rot_pair(uint32_t w, const PairLane& p) {
  if constexpr (N == 0) {
    return w;
  } else if constexpr (N % 2 == 0) {
    return __funnelshift_l(w, w, N / 2);
  } else {
    const uint32_t x = kProfile & 2 ? __byte_perm(w, 0, 0x1032) : __shfl_xor_sync(0xffffffffu, w, 1);
    return __funnelshift_l(x, x, N / 2 + p.up);  // N / 2 + 1 = 32 wraps to 0, as it should
  }
}

template <int X, int Y>
__device__ __forceinline__ void rho_pi(uint32_t (&b)[25], const uint32_t (&a)[25], const PairLane& p) {
  b[Y + 5 * ((2 * X + 3 * Y) % 5)] = rot_pair<rho_offset(X, Y)>(a[X + 5 * Y], p);
}

template <int X, int... Y>
__device__ __forceinline__ void rho_pi_column(uint32_t (&b)[25], const uint32_t (&a)[25], const PairLane& p) {
  (rho_pi<X, Y>(b, a, p), ...);
}

// rc: (24, 2) interleaved round constants, [r][0] the even bits.  Two
// rounds a loop iteration: the second round's theta overlaps the first's
// last exchanges (12% faster absorbing than one round, on an H100).
__device__ __forceinline__ void keccak_f_pair(uint32_t (&a)[25], const uint32_t* __restrict__ rc,
                                              const PairLane& p, uint32_t parity) {
#pragma unroll 2
  for (int r = 0; r < 24; ++r) {
    uint32_t c[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint32_t d = c[(x + 4) % 5] ^ rot_pair<1>(c[(x + 1) % 5], p);
#pragma unroll
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d;
    }
    uint32_t b[25];
    rho_pi_column<0, 0, 1, 2, 3, 4>(b, a, p);
    rho_pi_column<1, 0, 1, 2, 3, 4>(b, a, p);
    rho_pi_column<2, 0, 1, 2, 3, 4>(b, a, p);
    rho_pi_column<3, 0, 1, 2, 3, 4>(b, a, p);
    rho_pi_column<4, 0, 1, 2, 3, 4>(b, a, p);
#pragma unroll
    for (int y = 0; y < 5; ++y)
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= __ldg(rc + 2 * r + parity);
  }
}

// ---- the kernel --------------------------------------------------------------

// The card's nanosecond clock, in order with the memory operations about it.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

// One thread a state: from the zero state absorb nb of the rate blocks at
// `blk`, each followed by a permutation (the next block's loads in flight
// during it), and write the digest's 4 lanes to `out`.
__device__ __forceinline__ void run_thread(uint64_t* __restrict__ out, const uint64_t* __restrict__ blk, int nb,
                                           const uint64_t* __restrict__ rc) {
  uint64_t a[25], w[17];
#pragma unroll
  for (int q = 0; q < 25; ++q) a[q] = 0ull;
#pragma unroll
  for (int q = 0; q < 17; ++q) w[q] = nb > 0 ? blk[q] : 0ull;
  for (int t = 0; t < nb; ++t) {
#pragma unroll
    for (int q = 0; q < 17; ++q) a[q] ^= w[q];
#pragma unroll
    for (int q = 0; q < 17; ++q) w[q] = t + 1 < nb ? blk[(t + 1) * 17 + q] : 0ull;
    keccak_f(a, rc);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = a[q];
}

// A pair of lanes a state, on (lo, hi) words, as run_thread: the lane of
// parity `parity` reads and writes word `parity` of each lane.  Every lane
// of the warp calls it (`live` false: compute, store nothing), and the
// warp walks the most blocks any of its states has, so it stays converged
// for the exchanges; a state writes its digest after its own last block.
// Loads are issued before the exchanges that follow them, never between,
// so that they stay in flight together.
__device__ __forceinline__ void run_pair(uint32_t* __restrict__ out, const uint32_t* __restrict__ blk, int nb,
                                         bool live, const uint32_t* __restrict__ rc) {
  const uint32_t parity = threadIdx.x & 1;
  const PairLane p{parity ? 0x3276u : 0x5410u, parity ^ 1};
  uint32_t a[25], w[17];
#pragma unroll
  for (int q = 0; q < 25; ++q) a[q] = 0u;
#pragma unroll
  for (int q = 0; q < 17; ++q) w[q] = nb > 0 ? blk[2 * q + parity] : 0u;
  if (live && nb == 0) {  // the zero state's digest
#pragma unroll
    for (int q = 0; q < 4; ++q) out[2 * q + parity] = 0u;
  }
  const int most = __reduce_max_sync(0xffffffffu, nb);
  for (int t = 0; t < most; ++t) {
#pragma unroll
    for (int q = 0; q < 17; ++q) a[q] ^= interleave(w[q], p);
#pragma unroll
    for (int q = 0; q < 17; ++q) w[q] = t + 1 < nb ? blk[(t + 1) * 34 + 2 * q + parity] : 0u;
    keccak_f_pair(a, rc, p, parity);
    if (__any_sync(0xffffffffu, t == nb - 1)) {
      uint32_t d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = deinterleave(a[q], p);
      if (live && t == nb - 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) out[2 * q + parity] = d[q];
      }
    }
  }
}

// One permutation of each state of a block of threads (kThreads / 2 states
// from `first`), a pair of lanes a state.  The block's states pass through
// shared memory, so that global memory is read and written in whole lines
// (a state is 200 bytes: read in place, each warp load or store touches 16
// lines); a pair past the batch computes on stale words and stores
// nothing.  Each lane reads and writes only its own words of the stage,
// bank-conflict free (the 16 states of a warp start 50 words apart).
__device__ __forceinline__ void permute_pair_block(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                                   const uint32_t* __restrict__ rc, long long first,
                                                   long long batch) {
  constexpr int kWords = kThreads / 2 * 50;
  __shared__ uint32_t stage[kWords];
  const uint32_t parity = threadIdx.x & 1;
  const PairLane p{parity ? 0x3276u : 0x5410u, parity ^ 1};
  const int words = (int)min((long long)kWords, (batch - first) * 50);
  in += first * 50, out += first * 50;
  unsigned long long ns[4] = {};  // RAIKO_HASH_PROFILE & 4: entry, first round, after the last, stored
  long long clocks = 0;
  if constexpr (kProfile & 4) ns[0] = global_ns();
  for (int i = threadIdx.x; i < words; i += kThreads) stage[i] = in[i];
  __syncthreads();
  uint32_t* mine = stage + (threadIdx.x >> 1) * 50 + parity;
  uint32_t a[25];
#pragma unroll
  for (int q = 0; q < 25; ++q) a[q] = interleave(mine[2 * q], p);
  if constexpr (kProfile & 4) clocks = -clock64(), ns[1] = global_ns();
  keccak_f_pair(a, rc, p, parity);
  if constexpr (kProfile & 4) clocks += clock64(), ns[2] = global_ns();
#pragma unroll
  for (int q = 0; q < 25; ++q) mine[2 * q] = deinterleave(a[q], p);
  __syncthreads();
  for (int i = threadIdx.x; i < words; i += kThreads) out[i] = stage[i];
  if constexpr (kProfile & 4) {
    ns[3] = global_ns();
    __syncthreads();
    // over the first state of each warp, the even lane: clocks over the
    // rounds, ns loading, entry (low word); the odd lane: ns over the
    // rounds, ns storing, the stores issued
    const uint32_t stamp[2][3] = {{(uint32_t)clocks, (uint32_t)(ns[1] - ns[0]), (uint32_t)ns[0]},
                                  {(uint32_t)(ns[2] - ns[1]), (uint32_t)(ns[3] - ns[2]), (uint32_t)ns[3]}};
    const int state = (threadIdx.x >> 1);
    if ((threadIdx.x & 31) < 2 && first + state < batch) {
#pragma unroll
      for (int q = 0; q < 3; ++q) out[state * 50 + 2 * q + parity] = stamp[parity][q];
    }
  }
}

// LANES threads a state.  kAbsorb: Keccak-256 of item i, its first
// nblocks[i] (at most max_blocks) of its max_blocks rate blocks absorbed
// from the zero state, the items of a block of threads ordered by that
// count, 4 lanes (the digest) out; else (a pair only) one permutation of
// each state, 25 lanes out.  Words are u32 (lo, hi) pairs; LANES = 1 reads
// them as u64.
template <int LANES, bool kAbsorb>
__global__ void __launch_bounds__(kThreads)
    keccak_kernel(const uint32_t* __restrict__ state_in, uint32_t* __restrict__ state_out,
                  const uint32_t* __restrict__ blocks, const int* __restrict__ nblocks,
                  const uint32_t* __restrict__ rc, long long batch, int max_blocks) {
  static_assert(LANES == 2 || kAbsorb, "one thread a state only absorbs");
  constexpr int kItems = kThreads / LANES;
  const long long first = (long long)blockIdx.x * kItems;
  if constexpr (!kAbsorb) {
    permute_pair_block(state_in, state_out, rc, first, batch);
  } else {
    // the pair orders at every width, one thread a state above kOrderAbove
    // messages (order_by_count.cuh)
    const bool ordered = !(kProfile & 1) && max_blocks > 1 && (LANES == 2 || batch > kOrderAbove);
    const int slot = threadIdx.x / LANES;
    const long long taken =
        first + (ordered ? order_by_count<kItems>(nblocks, first, batch, max_blocks, slot) : slot);
    const bool live = taken < batch;
    if (LANES == 1 && !live) return;
    const long long item = live ? taken : batch - 1;  // a pair past the batch computes on the last item
    const int nb = live ? max(0, min(nblocks[item], max_blocks)) : 0;
    if constexpr (LANES == 1) {
      run_thread(reinterpret_cast<uint64_t*>(state_out) + item * 4,
                 reinterpret_cast<const uint64_t*>(blocks) + item * max_blocks * 17, nb,
                 reinterpret_cast<const uint64_t*>(rc));
    } else {
      run_pair(state_out + item * 8, blocks + item * max_blocks * 34, nb, live, rc);
    }
  }
}

}  // namespace
}  // namespace raiko

// See keccak_kernel: one permutation of each state of state_in where blocks
// is null (lanes = 2 only), else Keccak-256 of the blocks; rc: the 24
// round constants as (lo, hi) words for lanes = 1, as (even, odd)
// interleaved words for lanes = 2.  For lanes = 1 the block pointer is
// 8-byte aligned (the wrappers check).
extern "C" int raiko_keccak_f1600(const void* state_in, void* state_out, const void* blocks,
                                  const void* nblocks, const void* rc, long long batch,
                                  int max_blocks, int lanes, void* stream) {
  const bool absorb = blocks != nullptr;
  if ((lanes != 1 && lanes != 2) || (absorb ? max_blocks < 1 || nblocks == nullptr : state_in == nullptr || lanes != 2))
    return (int)cudaErrorInvalidValue;
  if (batch > 0) {
    const long long items = raiko::kThreads / lanes;
    const unsigned grid = (unsigned)((batch + items - 1) / items);
    const auto kernel = lanes == 1 ? raiko::keccak_kernel<1, true>
                                   : (absorb ? raiko::keccak_kernel<2, true> : raiko::keccak_kernel<2, false>);
    kernel<<<grid, raiko::kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)state_in, (uint32_t*)state_out, (const uint32_t*)blocks, (const int*)nblocks,
        (const uint32_t*)rc, batch, max_blocks);
  }
  return (int)cudaGetLastError();
}
