// Poseidon2 over BabyBear for Hopper (sm_90a): the STARK commitment's row
// sponge (poseidon2_hash_rows), the Merkle 2-to-1 compression
// (poseidon2_compress) and the whole Merkle tree (poseidon2_merkle).
//
// Counterparts of raiko_tpu/ops/poseidon2.py hash_rows and compress, and of
// raiko_tpu/ops/merkle.py commit (compress level by level), which the JAX
// package leaves to XLA (there is no Pallas kernel for them): width
// 16, S-box x^7, 4 + 4 external rounds around 13 internal rounds, the M4
// circulant external layer and the sum + diag(mu) internal layer, with the
// reference's derived constants handed in by the wrapper.  Every value is
// canonical Montgomery form, so outputs equal the reference bit for bit,
// whatever order the sums' terms are added in.
//
// What bounds them on the card, and the design:
// * One permutation is 21 rounds of 772 Montgomery products (each 4 32-bit
//   multiplies) on 64 bytes of state: both kernels are bound by integer
//   multiplies, never by bytes.  At the keccak chunk's commitment (4,096
//   rows of 4,160 columns) a row is 520 permutations in sequence.
// * hash_rows: the sponge is sequential, and one thread per row would make
//   the commitment's 4,096 rows 128 warps, one per SM on one of its four
//   schedulers, with nothing to hide a round's chain of dependent products.
//   So each row's sponge runs on a group of four lanes, one block of the
//   external layer's M4 per lane: 512 warps, one for every scheduler of
//   128 SMs.
//   - An external round is the lane's four S-boxes and its M4 in
//     registers, then the sum of each position over the four blocks by two
//     xor shuffles.
//   - In an internal round every lane keeps word 0 too and runs its S-box
//     itself, while the group sums the other 15 words by two xor shuffles,
//     so a round waits on the S-box chain alone; word 0's own update is
//     part + (1 + mu_0) sb, one product after the S-box.
//   - The round constants sit in registers; the products by constants
//     (mu) take their Montgomery factor precomputed (bb::mul_c).
//   - The lanes holding words 0-7 read the next chunk while the current
//     one is permuted.
//   Still one warp per scheduler, so the time is each lane's chain of
//   dependent instructions, not the multiply rate: 1.65 ms at the keccak
//   chunk's shape on an H100 80GB HBM3 (700 W), 24% of the multiply bound.
//   Four lanes per row beat eight and sixteen (2.08 and 2.81 ms), which run
//   more S-boxes and shuffles per row than they gain in warps (PERF.md).
//   ptxas (nvcc 12.9, sm_90a, -O3) gives hash_rows_kernel 92 registers, no
//   spills.
// * compress and the Merkle tree: a permutation per pair of digests on the
//   same group of four lanes as hash_rows (row_permute and RowConsts are
//   shared), so a level costs one four-lane permutation's latency, and
//   merkle_kernel builds every level in one launch, with no host dispatch
//   between levels.  A block takes a task
//   of 2^7 nodes (64 pairs, 256 threads) and builds the 7 levels above them
//   in shared memory, writing each level out; the last of 2^7 sibling
//   blocks to finish (a ticket counter, after a __threadfence) goes on
//   with their roots, read from L2, and so on up.  The tree over 4,096
//   leaves is 32 blocks and then one, a chain of 12 permutations: bound by
//   that chain's latency, not by the 4,095 permutations' multiplies: 0.050
//   ms on an H100 80GB HBM3 (700 W), 4.1 us a level; compress at 2,048
//   pairs 0.0050 ms.  ptxas: merkle_kernel 80 registers, compress_kernel
//   32, no spills.
// * hash_rows reads the row matrix through two strides, so the commitment
//   hashes the rows of the LDE's transpose without a transpose: element w of
//   row i is x[i * stride_row + w * stride_col], and with stride_row = 1 the
//   eight rows of a warp read 32 contiguous bytes per column.

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
constexpr uint32_t kMontOne = 268435454u;  // 2^32 mod p: 1 in Montgomery form

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint32_t x2 = bb::mul(x, x);
  const uint32_t x4 = bb::mul(x2, x2);
  const uint32_t x3 = bb::mul(x2, x);
  return bb::mul(x4, x3);
}

// M4 [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] on four words by the
// add/double chain.
__device__ __forceinline__ void m4(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  const uint32_t t0 = bb::add(a, b);
  const uint32_t t1 = bb::add(c, d);
  const uint32_t t2 = bb::add(bb::add(b, b), t1);
  const uint32_t t3 = bb::add(bb::add(d, d), t0);
  const uint32_t t1x2 = bb::add(t1, t1);
  const uint32_t t4 = bb::add(bb::add(t1x2, t1x2), t3);
  const uint32_t t0x2 = bb::add(t0, t0);
  const uint32_t t5 = bb::add(bb::add(t0x2, t0x2), t2);
  a = bb::add(t3, t5);
  b = t5;
  c = bb::add(t2, t4);
  d = t4;
}

__device__ __forceinline__ void load_consts(uint32_t* sm, const uint32_t* __restrict__ consts) {
  for (int i = threadIdx.x; i < kConsts; i += blockDim.x) sm[i] = consts[i];
  __syncthreads();
}

// ---- hash_rows: one row's sponge over four lanes ---------------------------
//
// Lane l (0-3) of a row's group holds words 4l .. 4l + 3 of the state, one
// M4 block.  (ptxas schedules this code well; a rewrite with the same
// operations that passed the lane's index by value and updated the words in
// place took 80 registers, not 92, and 40% longer on the H100.)

constexpr int kRowLanes = 4;

// This lane's place in its row's group.
struct RowLane {
  uint32_t l;     // lane within the group
  uint32_t base;  // the group's first lane in the warp
  __device__ __forceinline__ RowLane() {
    const uint32_t lane = threadIdx.x & 31u;
    l = lane & (kRowLanes - 1);
    base = lane - l;
  }
};

// This lane's constants, in registers: its words' external round
// constants, the internal ones, its words' diagonal entries mu and, for
// word 0's own update, 1 + mu_0; each multiplier with its Montgomery factor.
struct RowConsts {
  uint32_t ext[kRoundsF][4], internal[kRoundsP];
  uint32_t mu[4], mu_n[4], mu0p1, mu0p1_n;
  __device__ __forceinline__ RowConsts(const RowLane& R, const uint32_t* c) {
#pragma unroll
    for (int r = 0; r < kRoundsF; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) ext[r][k] = c[kExtRc + r * kWidth + 4 * R.l + k];
#pragma unroll
    for (int r = 0; r < kRoundsP; ++r) internal[r] = c[kIntRc + r];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      mu[k] = c[kMu + 4 * R.l + k];
      mu_n[k] = mu[k] * bb::NPRIME;
    }
    mu0p1 = bb::add(c[kMu], kMontOne);
    mu0p1_n = mu0p1 * bb::NPRIME;
  }
};

// The external layer on a group: M4 on the lane's block, then each position
// adds its sum over the four blocks (lanes l ^ 1, l ^ 2).
__device__ __forceinline__ void row_external_linear(uint32_t (&s)[4]) {
  m4(s[0], s[1], s[2], s[3]);
  const uint32_t o[4] = {s[0], s[1], s[2], s[3]};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t sum = bb::add(o[k], __shfl_xor_sync(0xffffffffu, o[k], 1));
    sum = bb::add(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
    s[k] = bb::add(o[k], sum);
  }
}

__device__ __forceinline__ void row_external_round(uint32_t (&s)[4], const uint32_t (&rc)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) s[k] = sbox(bb::add(s[k], rc[k]));
  row_external_linear(s);
}

__device__ __forceinline__ void row_permute(const RowLane& R, uint32_t (&s)[4], const RowConsts& K) {
  row_external_linear(s);
#pragma unroll
  for (int r = 0; r < kRoundsF / 2; ++r) row_external_round(s, K.ext[r]);
  uint32_t x0 = __shfl_sync(0xffffffffu, s[0], R.base);
#pragma unroll
  for (int r = 0; r < kRoundsP; ++r) {
    const uint32_t sb = sbox(bb::add(x0, K.internal[r]));
    // the other 15 words' sum (lane 0 leaves its word 0 out)
    uint32_t part = R.l == 0 ? 0u : s[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) part = bb::add(part, s[k]);
#pragma unroll
    for (int o = 1; o < kRowLanes; o <<= 1) part = bb::add(part, __shfl_xor_sync(0xffffffffu, part, o));
    const uint32_t sum = bb::add(part, sb);
    if (R.l == 0) s[0] = sb;
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = bb::add(sum, bb::mul_c(s[k], K.mu[k], K.mu_n[k]));
    // word 0: sum + mu_0 sb = part + (1 + mu_0) sb, one addition after sb's product
    x0 = bb::add(part, bb::mul_c(sb, K.mu0p1, K.mu0p1_n));
  }
#pragma unroll
  for (int r = kRoundsF / 2; r < kRoundsF; ++r) row_external_round(s, K.ext[r]);
}

// Sponge of each row: absorb RATE elements per permutation (the last chunk
// zero-padded), the row's width (Montgomery, `width_sep`) in the last
// capacity word; the digest is the state's first OUT words.  Row i is group
// i of the grid; a group past the last row hashes the last row again and
// stores nothing, so every lane of a warp takes part in every shuffle.
__global__ void __launch_bounds__(64) hash_rows_kernel(const uint32_t* __restrict__ x,
                                                      uint32_t* __restrict__ out,
                                                      const uint32_t* __restrict__ consts,
                                                      long long rows, int width,
                                                      long long stride_row, long long stride_col,
                                                      uint32_t width_sep) {
  __shared__ uint32_t c[kConsts];
  load_consts(c, consts);
  const RowLane R;
  const long long row_g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kRowLanes;
  const long long row = row_g < rows ? row_g : rows - 1;
  const RowConsts K(R, c);
  uint32_t s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) s[k] = 0;
  if (R.l == kRowLanes - 1) s[3] = width_sep;
  const uint32_t* src = x + row * stride_row;
  const int nchunks = width > 0 ? (width + kRate - 1) / kRate : 1;
  // lanes 0 and 1 hold words 0-7, the rate
  uint32_t next[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int w = 4 * R.l + k;
    next[k] = w < kRate && w < width ? src[(long long)w * stride_col] : 0u;
  }
  for (int ch = 0; ch < nchunks; ++ch) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = bb::add(s[k], next[k]);
    if (ch + 1 < nchunks) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * R.l + k, w = (ch + 1) * kRate + i;
        next[k] = i < kRate && w < width ? src[(long long)w * stride_col] : 0u;
      }
    }
    row_permute(R, s, K);
  }
  if (row_g < rows) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * R.l + k < kOut) out[row * kOut + 4 * R.l + k] = s[k];
  }
}

// ---- compress and Merkle trees: one permutation per group of four lanes -----
//
// A pair's state (left digest, right digest) sits on a group as in
// hash_rows: lanes 0-1 hold the left digest, lanes 2-3 the right, and after
// row_permute lanes 0-1 hold the compressed digest.

// out[i] = permute(state[i])[:OUT] for contiguous (n, 16) states.  A group
// past the last state permutes the last one again and stores nothing, so
// every lane of a warp takes part in every shuffle.
__global__ void __launch_bounds__(128) compress_kernel(const uint32_t* __restrict__ state,
                                                       uint32_t* __restrict__ out,
                                                       const uint32_t* __restrict__ consts,
                                                       long long n) {
  __shared__ uint32_t c[kConsts];
  load_consts(c, consts);
  const RowLane R;
  const RowConsts K(R, c);
  const long long i_g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kRowLanes;
  const long long i = i_g < n ? i_g : n - 1;
  const uint4 w = reinterpret_cast<const uint4*>(state)[i * 4 + R.l];
  uint32_t s[4] = {w.x, w.y, w.z, w.w};
  row_permute(R, s, K);
  if (i_g < n && R.l < 2) reinterpret_cast<uint4*>(out)[i * 2 + R.l] = make_uint4(s[0], s[1], s[2], s[3]);
}

// A Merkle task takes 2^kTaskLog nodes of one level and builds the
// kTaskLog levels above them (fewer at the top of the tree), one group of
// four lanes per pair of its first level.
constexpr int kTaskLog = 7;
constexpr int kTreeThreads = kRowLanes << (kTaskLog - 1);

// The first node of level `level` (1 .. log_n) in the (N - 1, 8) buffer of
// internal nodes, levels one after another from the leaves' parents up.
__device__ __forceinline__ size_t level_offset(int log_n, int level) {
  return ((size_t)1 << log_n) - ((size_t)1 << (log_n - level + 1));
}

// Every level of the tree over 2^log_n leaves (log_n >= 1) in one launch.
// Block b starts with task b on the leaves, keeping each level in shared
// memory and writing it out.  A finished task takes a ticket for its
// parent task (the task over its 2^kTaskLog siblings' roots); the last of
// the siblings to arrive goes on with the parent, reading the siblings'
// roots from L2, and so on until one block writes the root.  `tickets`
// holds a zero for each parent task (at most N / 2).
__global__ void __launch_bounds__(kTreeThreads) merkle_kernel(const uint32_t* __restrict__ leaves,
                                                              uint32_t* out,
                                                              const uint32_t* __restrict__ consts,
                                                              int log_n, unsigned* tickets) {
  __shared__ uint32_t c[kConsts];
  __shared__ uint4 nodes[2][1 << (kTaskLog - 1)][2];
  __shared__ bool last;
  load_consts(c, consts);
  const RowLane R;
  const RowConsts K(R, c);
  const int q = threadIdx.x / kRowLanes;
  const int half = R.l & 1, side = R.l >> 1;
  int level = 0;  // the input level of this block's task
  long long task = blockIdx.x;
  long long ticket_base = 0;
  while (true) {
    const int lv = min(kTaskLog, log_n - level);
    for (int d = 0; d < lv; ++d) {
      const int pairs = 1 << (lv - d - 1);
      if ((int)(threadIdx.x & ~31u) < pairs * kRowLanes) {
        const int p = min(q, pairs - 1);  // groups past the last pair repeat it
        uint4 w;
        if (d > 0) {
          w = nodes[(d - 1) & 1][2 * p + side][half];
        } else {
          const long long node = (task << lv) + 2 * p + side;
          w = level == 0 ? reinterpret_cast<const uint4*>(leaves)[node * 2 + half]
                         : __ldcg(reinterpret_cast<const uint4*>(out + level_offset(log_n, level) * 8) +
                                  node * 2 + half);
        }
        uint32_t s[4] = {w.x, w.y, w.z, w.w};
        row_permute(R, s, K);
        if (q < pairs && side == 0) {
          const uint4 o = make_uint4(s[0], s[1], s[2], s[3]);
          nodes[d & 1][q][half] = o;
          const long long node = (task << (lv - d - 1)) + q;
          reinterpret_cast<uint4*>(out + level_offset(log_n, level + d + 1) * 8)[node * 2 + half] = o;
        }
      }
      __syncthreads();
    }
    level += lv;
    if (level == log_n) return;  // this block wrote the root
    __threadfence();             // this task's root, visible before its ticket
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned siblings = 1u << min(kTaskLog, log_n - level);
      last = atomicAdd(tickets + ticket_base + (task >> kTaskLog), 1u) == siblings - 1;
      __threadfence();
    }
    __syncthreads();
    if (!last) return;
    ticket_base += 1LL << max(0, log_n - level - kTaskLog);
    task >>= kTaskLog;
  }
}

}  // namespace
}  // namespace raiko

extern "C" int raiko_poseidon2_hash_rows(const void* x, void* out, const void* consts,
                                         long long rows, int width, long long stride_row,
                                         long long stride_col, unsigned width_sep,
                                         void* stream) {
  if (rows > 0) {
    const int threads = 64;
    const long long blocks = (rows * raiko::kRowLanes + threads - 1) / threads;
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
    const long long blocks = (n * raiko::kRowLanes + threads - 1) / threads;
    raiko::compress_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)state, (uint32_t*)out, (const uint32_t*)consts, n);
  }
  return (int)cudaGetLastError();
}

// All N - 1 internal nodes of the Merkle tree over (2^log_n, 8) leaves into
// out, level 1 (the leaves' parents) first and the root last; tickets:
// at least max(1, N / 2) zeroed words.
extern "C" int raiko_poseidon2_merkle(const void* leaves, void* out, const void* consts, int log_n,
                                      void* tickets, void* stream) {
  if (log_n > 0) {
    const long long blocks = 1LL << (log_n > raiko::kTaskLog ? log_n - raiko::kTaskLog : 0);
    raiko::merkle_kernel<<<(unsigned)blocks, raiko::kTreeThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)leaves, (uint32_t*)out, (const uint32_t*)consts, log_n,
        (unsigned*)tickets);
  }
  return (int)cudaGetLastError();
}
