// Ordering a ragged batch by length inside a block of threads, for the hash
// kernels (keccak_f1600.cu, sha256.cu).
//
// A warp runs as long as the longest message among its lanes.  Before it
// hashes, a block of threads orders the kItems messages it owns by their
// block counts with a counting sort in shared memory (no extra launch), so
// that its warps take messages of equal count together; every digest is
// still written at its caller's index.  Messages of equal count keep no
// particular order, which no result depends on.
//
// Where it pays, on an NVIDIA H100 80GB HBM3 at 700 W (CUDA graphs,
// tools/time_hashes.py): once the card holds several warps a scheduler, a
// warp's most blocks sets how long it holds its slot, and ordering took
// 15-21% off from 65,536 messages (Keccak absorbing in either layout,
// SHA-256 one thread a message).  Below, each warp is about alone on its
// scheduler and the longest message sets the time whatever the order: up
// to 32,768 messages one thread a message ran 2-10% slower ordered (the
// sort's barriers), so it orders only above kOrderAbove.  The Keccak pair
// ran 2-4% faster ordered at 8,192 and 16,384 messages and orders at every
// width.  SHA-256's split layout runs only up to 8,192 messages, where a
// mix sorted by length on the host ran as fast as unsorted (8.8-9.3 us
// either way): it does not order.

#pragma once

#include <cuda_runtime.h>

namespace raiko {

constexpr long long kOrderAbove = 32768;  // one thread a message orders above this many
constexpr int kCountBins = 32;  // block counts >= kCountBins - 1 share the last bin
static_assert(kCountBins == 32, "the first warp scans the bins");

// The item (an offset from `first`) that slot `slot` of this block of threads
// takes: a permutation of 0 .. kItems - 1 that groups equal counts
// min(nblocks[first + i], max_blocks), items past the batch counting 0.
// Every thread of the block calls it; the block has at least kItems threads.
template <int kItems>
__device__ __forceinline__ int order_by_count(const int* __restrict__ nblocks, long long first, long long batch,
                                              int max_blocks, int slot) {
  __shared__ int bins[kCountBins];
  __shared__ int order[kItems];
  const int tid = threadIdx.x;
  if (tid < kCountBins) bins[tid] = 0;
  __syncthreads();
  int bin = 0, rank = 0;
  if (tid < kItems) {
    const long long i = first + tid;
    bin = i < batch ? max(0, min(min(nblocks[i], max_blocks), kCountBins - 1)) : 0;
    rank = atomicAdd(&bins[bin], 1);
  }
  __syncthreads();
  if (tid < 32) {  // exclusive scan of the bins by the first warp
    const int v = bins[tid];
    int sum = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, sum, o);
      if (tid >= o) sum += n;
    }
    bins[tid] = sum - v;
  }
  __syncthreads();
  if (tid < kItems) order[bins[bin] + rank] = tid;
  __syncthreads();
  return order[slot];
}

}  // namespace raiko
