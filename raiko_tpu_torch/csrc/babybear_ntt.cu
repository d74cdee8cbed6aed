// BabyBear NTT for Hopper (sm_90a): kernel B5, forward DIF and inverse DIT.
//
// Replaces raiko_tpu/ops/ntt_pallas.py: ntt_fused and intt_fused (the
// fused four-step kernel _fourstep_fused), and covers every size the
// reference's ops/ntt.py covers (2 <= N <= 2^24 here), not only
// 2^14..2^20.
//
// Layout: (batch, N) u32 Montgomery rows, contiguous.  The forward
// transform takes natural order to bit-reversed order; the inverse takes
// bit-reversed order to natural order and scales by 1/N.  Outputs equal
// raiko_tpu/ops/ntt.py ntt / intt bit for bit: field arithmetic is exact and
// every value canonical, so any correct evaluation order agrees.
//
// What bounds it on the card, and the design:
// * A transform moves each element in and out once (8 bytes) and does
//   log2(N)/2 Montgomery products per element (4 32-bit multiplies each), so
//   at the STARK commitment's sizes (N = 1,024 and 4,096, batch 4,160) it is
//   bound by device-memory bytes, as the Pallas kernel was by HBM traffic.
//   The design keeps every butterfly stage in shared memory: a row is read
//   from device memory once and written once, as in the fused Pallas
//   kernel.
// * N <= 4096 (16 KB): one block holds whole rows (several when N is
//   small) and runs all log2(N) stages there, synchronising between
//   stages.  One table of w^j, j < N/2, serves every stage at stride 2^s.
// * N > 4096: the four-step split of the Pallas kernel, N = R x C with
//   R = 2^(log N / 2): a column pass (the length-R transforms down the
//   columns of the row viewed as R x C, a tile of columns per block in
//   shared memory, then the cross twiddles) and a row pass (the length-C
//   transforms along the rows, by the small-N kernel).  The Pallas kernel's
//   transposes become the column tile's strided loads.  The inverse runs the
//   two passes in the mirror order.
// The Pallas kernel's TPU layout (butterflies along sublanes, twiddles
// packed column-wise for (half, 1) sublane reads) does not carry over.

#include <cuda_runtime.h>

#include "babybear.cuh"

namespace raiko {
namespace {

constexpr int kThreads = 256;
constexpr int kRowElems = 4096;   // elements of the small-N kernel's block
constexpr int kColElems = 8192;   // elements of a column tile (32 KB)

// DIF stages over `nrows` transforms of 2^log_n elements each, held
// contiguously in shared memory (transform r from sm[r << log_n]).
__device__ __forceinline__ void dif_stages(uint32_t* sm, int nrows, int log_n,
                                           const uint32_t* __restrict__ tw) {
  const int half_n = 1 << (log_n - 1);
  const int bfly = nrows * half_n;
  for (int s = 0; s < log_n; ++s) {
    const int lh = log_n - 1 - s;  // log2 of this stage's half length
    const int half = 1 << lh;
    for (int b = threadIdx.x; b < bfly; b += blockDim.x) {
      const int r = b >> (log_n - 1);
      const int j = b & (half_n - 1);
      const int k = j & (half - 1);
      const int i0 = (r << log_n) + ((j >> lh) << (lh + 1)) + k;
      const int i1 = i0 + half;
      const uint32_t u = sm[i0], v = sm[i1];
      sm[i0] = bb::add(u, v);
      sm[i1] = bb::mul(bb::sub(u, v), __ldg(tw + (k << s)));
    }
    __syncthreads();
  }
}

// DIT stages (the DIF stages undone in reverse order, inverse twiddles).
__device__ __forceinline__ void dit_stages(uint32_t* sm, int nrows, int log_n,
                                           const uint32_t* __restrict__ tw) {
  const int half_n = 1 << (log_n - 1);
  const int bfly = nrows * half_n;
  for (int s = log_n - 1; s >= 0; --s) {
    const int lh = log_n - 1 - s;
    const int half = 1 << lh;
    for (int b = threadIdx.x; b < bfly; b += blockDim.x) {
      const int r = b >> (log_n - 1);
      const int j = b & (half_n - 1);
      const int k = j & (half - 1);
      const int i0 = (r << log_n) + ((j >> lh) << (lh + 1)) + k;
      const int i1 = i0 + half;
      const uint32_t u = sm[i0];
      const uint32_t v = bb::mul(sm[i1], __ldg(tw + (k << s)));
      sm[i0] = bb::add(u, v);
      sm[i1] = bb::sub(u, v);
    }
    __syncthreads();
  }
}

// Whole rows of 2^log_n elements, `per_block` rows per block.  `scale`
// (Montgomery), when nonzero, multiplies every output.  `x` may equal `out`:
// a block reads its rows completely before it writes them.
template <bool kInverse>
__global__ void __launch_bounds__(kThreads) ntt_rows_kernel(const uint32_t* x, uint32_t* out,
                                                            const uint32_t* __restrict__ tw,
                                                            long long rows, int log_n,
                                                            int per_block, uint32_t scale) {
  __shared__ uint32_t sm[kRowElems];
  const long long row0 = (long long)blockIdx.x * per_block;
  const int nrows = (int)min((long long)per_block, rows - row0);
  const size_t base = (size_t)row0 << log_n;
  const int total = nrows << log_n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) sm[i] = x[base + i];
  __syncthreads();
  if (kInverse) {
    dit_stages(sm, nrows, log_n, tw);
  } else {
    dif_stages(sm, nrows, log_n, tw);
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x)
    out[base + i] = scale ? bb::mul(sm[i], scale) : sm[i];
}

// The four-step column pass over rows viewed as (R, C) = (2^log_r, 2^log_c):
// block (b, tile) holds columns [c0, c0 + tc) of row b, column-major in
// shared memory.  Forward: DIF down each column, then times cross[r][c].
// Inverse: times cross[r][c] (the inverse table), DIT down each column,
// then times `scale`.  In place is safe, as in ntt_rows_kernel.
template <bool kInverse>
__global__ void __launch_bounds__(kThreads) ntt_cols_kernel(const uint32_t* x, uint32_t* out,
                                                            const uint32_t* __restrict__ tw,
                                                            const uint32_t* __restrict__ cross,
                                                            int log_r, int log_c, int log_tc,
                                                            uint32_t scale) {
  __shared__ uint32_t sm[kColElems];
  const int tiles = 1 << (log_c - log_tc);
  const long long b = blockIdx.x >> (log_c - log_tc);
  const int c0 = (int)(blockIdx.x & (tiles - 1)) << log_tc;
  const size_t base = (size_t)b << (log_r + log_c);
  const int tc_mask = (1 << log_tc) - 1;
  const int total = 1 << (log_r + log_tc);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i >> log_tc, cc = i & tc_mask;
    const size_t g = ((size_t)r << log_c) + c0 + cc;
    uint32_t v = x[base + g];
    if (kInverse) v = bb::mul(v, __ldg(cross + g));
    sm[(cc << log_r) + r] = v;
  }
  __syncthreads();
  if (kInverse) {
    dit_stages(sm, 1 << log_tc, log_r, tw);
  } else {
    dif_stages(sm, 1 << log_tc, log_r, tw);
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i >> log_tc, cc = i & tc_mask;
    const size_t g = ((size_t)r << log_c) + c0 + cc;
    uint32_t v = sm[(cc << log_r) + r];
    v = kInverse ? (scale ? bb::mul(v, scale) : v) : bb::mul(v, __ldg(cross + g));
    out[base + g] = v;
  }
}

template <bool kInverse>
void launch_rows(const uint32_t* x, uint32_t* out, const uint32_t* tw, long long rows, int log_n,
                 uint32_t scale, cudaStream_t stream) {
  const int per_block = (1 << log_n) >= kRowElems ? 1 : kRowElems >> log_n;
  const long long blocks = (rows + per_block - 1) / per_block;
  ntt_rows_kernel<kInverse><<<(unsigned)blocks, kThreads, 0, stream>>>(x, out, tw, rows, log_n,
                                                                      per_block, scale);
}

template <bool kInverse>
void launch_cols(const uint32_t* x, uint32_t* out, const uint32_t* tw, const uint32_t* cross,
                 long long batch, int log_r, int log_c, uint32_t scale, cudaStream_t stream) {
  int log_tc = 0;
  while (log_tc < log_c && (1 << (log_r + log_tc + 1)) <= kColElems) ++log_tc;
  const long long blocks = batch << (log_c - log_tc);
  ntt_cols_kernel<kInverse><<<(unsigned)blocks, kThreads, 0, stream>>>(x, out, tw, cross, log_r,
                                                                      log_c, log_tc, scale);
}

}  // namespace
}  // namespace raiko

// One B5 transform of `batch` rows of 2^log_n elements, x -> out.
// log_r == 0: one pass, tw_rows = w_N^j (j < N/2).  log_r > 0: the four-step
// split with R = 2^log_r, C = 2^(log_n - log_r), tw_rows = w_C^j (j < C/2),
// tw_cols = w_R^j (j < R/2), cross = the (R, C) cross twiddles.  All tables
// Montgomery, inverse roots for the inverse.  ninv = Montgomery 1/N, applied
// by the inverse only.
extern "C" int raiko_babybear_ntt(const void* x, void* out, const void* tw_rows,
                                  const void* tw_cols, const void* cross, long long batch,
                                  int log_n, int log_r, int inverse, unsigned ninv,
                                  void* stream) {
  using namespace raiko;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* xi = (const uint32_t*)x;
  uint32_t* o = (uint32_t*)out;
  const uint32_t* twr = (const uint32_t*)tw_rows;
  const uint32_t* twc = (const uint32_t*)tw_cols;
  const uint32_t* cr = (const uint32_t*)cross;
  if (batch <= 0) return (int)cudaGetLastError();
  if (log_r == 0) {
    if (inverse) {
      launch_rows<true>(xi, o, twr, batch, log_n, ninv, st);
    } else {
      launch_rows<false>(xi, o, twr, batch, log_n, 0u, st);
    }
    return (int)cudaGetLastError();
  }
  const int log_c = log_n - log_r;
  if (inverse) {
    launch_rows<true>(xi, o, twr, batch << log_r, log_c, 0u, st);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    launch_cols<true>(o, o, twc, cr, batch, log_r, log_c, ninv, st);
  } else {
    launch_cols<false>(xi, o, twc, cr, batch, log_r, log_c, 0u, st);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    launch_rows<false>(o, o, twr, batch << log_r, log_c, 0u, st);
  }
  return (int)cudaGetLastError();
}
