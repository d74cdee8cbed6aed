// BabyBear NTT by exact int8 limb products for Hopper (sm_90a): kernel B6.
//
// Replaces raiko_tpu/ops/ntt_mxu.py: ntt_mxu_pallas (kernel _mxu_dft_pallas),
// and computes what raiko_tpu/ops/ntt_mxu.py:ntt_mxu computes: the forward
// NTT of (batch, N) u32 Montgomery rows, N = R x C with R = 2^(log N / 2)
// and R, C <= 128, natural order in, bit-reversed order out, bit for bit the
// result of raiko_tpu/ops/ntt.py:ntt.
//
// The transform is two DFT passes over each row viewed as (R, C):
//   pass 1: a[k, c] = (sum_j W_R[k, j] x[j, c]) * cross[k, c]  (down columns)
//   pass 2: y[r, k] =  sum_j W_C[k, j] a[r, j]                  (along rows)
// where W_M[k, j] = w_M^(brp(k) j) in standard form.  Each dot product runs
// exactly over the integers: x and W are cut into four balanced signed
// 8-bit digits (x = sum_l 2^(8l) x_l, x_l in [-128, 128)), the 16 digit
// pairs are summed with __dp4a (four int8 products per instruction, into
// int32, exact: |S_s| <= 4 * 128 * 2^14 = 2^23), and the seven diagonal sums
// S_s = sum_{i+l=s} W_i . x_l are recombined mod p inside the kernel as
// sum_s mul(S_s + 2^23, 2^(8s) R) - K with babybear.cuh's mul/add/sub
// (consts = [2^(8s) R mod p for s < 7, K]).  The (4M, 4L) digit products of
// the Pallas kernel never reach device memory; nor do they exist here.
//
// What bounds it on the card, and the design:
// * The work is 16 N (R + C) int8 multiply-adds per row against 8 bytes per
//   element moved: well above the memory line, so arithmetic bounds it.  The
//   TPU's bf16 products with f32 sums were an artefact of its matrix unit;
//   on Hopper int8 products sum exactly in int32, so no float route.
// * This first version uses __dp4a on the CUDA cores, not the tensor cores
//   (mma.sync s8 or wgmma are later work): at its peak it is about 16x
//   slower than the int8 tensor-core rate that the bound counts.
// * A block owns one row's tile of up to 32 lanes (columns in pass 1, rows
//   in pass 2) and all M transform positions: it reads the tile once,
//   writes the lanes' packed digits to shared memory ([group][lane][limb]
//   as one 16-byte word per group and lane), and each thread computes
//   outputs (k, lane) from 16-byte shared loads of the digits and 16-byte
//   loads of the packed matrix row (the same address across a warp, a
//   broadcast).  Outputs go through shared memory so that both passes write
//   device memory in contiguous runs.  Pass 2 runs in place on pass 1's
//   output: a block reads its whole tile before any block writes it, and
//   tiles do not overlap.
// * One launch per pass; the cross twiddles ride on pass 1's stores.

#include <cuda_runtime.h>

#include "babybear.cuh"

namespace raiko {
namespace {

constexpr int kMaxM = 128;
constexpr int kMaxGroups = kMaxM / 4;
constexpr int kTile = 32;  // lanes per block: threadIdx.x
constexpr int kRowsY = 8;  // transform positions in flight: threadIdx.y
constexpr uint32_t kOffset = 1u << 23;

// One DFT pass over `batch` rows of M x L = 2^(log_m + log_l) elements.
// Element (j, lane) of a row lies at j * L + lane when !along_rows (pass 1:
// transform down columns) and at lane * M + j when along_rows (pass 2).
// w: (M, G) int4 packed matrix; cross: (M * L) Montgomery factors applied to
// the outputs at their positions, or null.
__global__ void __launch_bounds__(kTile * kRowsY)
    mxu_dft_kernel(const uint32_t* x, uint32_t* out, const int4* __restrict__ w,
                   const uint32_t* __restrict__ cross, const uint32_t* __restrict__ consts,
                   int log_m, int log_l, int along_rows) {
  __shared__ __align__(16) int8_t digits[kMaxGroups * kTile * 16];
  __shared__ uint32_t res[kMaxM * (kTile + 1)];  // [k][lane], padded rows
  const int m = 1 << log_m;
  const int log_tl = log_l < 5 ? log_l : 5;
  const int tl = 1 << log_tl;
  const int tiles_log = log_l - log_tl;
  const long long row = (long long)blockIdx.x >> tiles_log;
  const int lane0 = (int)(blockIdx.x & ((1u << tiles_log) - 1)) << log_tl;
  const size_t base = (size_t)row << (log_m + log_l);
  const int groups = (m + 3) >> 2;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * kRowsY;
  const int total = m << log_tl;

  // (j, lane) of tile index i, chosen so that neighbouring threads touch
  // neighbouring addresses of the row
  auto coords = [&](int i, int& j, int& lane) {
    if (along_rows) {
      j = i & (m - 1);
      lane = i >> log_m;
    } else {
      lane = i & (tl - 1);
      j = i >> log_tl;
    }
  };
  auto position = [&](int j, int lane) -> size_t {
    return along_rows ? ((size_t)(lane0 + lane) << log_m) + j
                      : ((size_t)j << log_l) + lane0 + lane;
  };

  if (m & 3) {  // M = 1 or 2: the digits past column M stay zero
    for (int i = tid; i < groups * tl * 4; i += nthreads) reinterpret_cast<int*>(digits)[i] = 0;
    __syncthreads();
  }
  for (int i = tid; i < total; i += nthreads) {
    int j, lane;
    coords(i, j, lane);
    const uint32_t v = x[base + position(j, lane)];
    int8_t* dst = digits + (((j >> 2) << log_tl) + lane) * 16 + (j & 3);
    uint32_t carry = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t d = ((v >> (8 * q)) & 0xFFu) + carry;
      carry = d >= 128u ? 1u : 0u;
      dst[4 * q] = (int8_t)((int)d - 256 * (int)carry);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x;
  if (lane < tl) {
    const int4* xd = reinterpret_cast<const int4*>(digits);
    for (int k = threadIdx.y; k < m; k += kRowsY) {
      const int4* wk = w + (size_t)k * groups;
      int s0 = 0, s1 = 0, s2 = 0, s3 = 0, s4 = 0, s5 = 0, s6 = 0;
      for (int g = 0; g < groups; ++g) {
        const int4 xv = xd[(g << log_tl) + lane];
        const int4 wv = __ldg(wk + g);
        s0 = __dp4a(wv.x, xv.x, s0);
        s1 = __dp4a(wv.x, xv.y, s1);
        s1 = __dp4a(wv.y, xv.x, s1);
        s2 = __dp4a(wv.x, xv.z, s2);
        s2 = __dp4a(wv.y, xv.y, s2);
        s2 = __dp4a(wv.z, xv.x, s2);
        s3 = __dp4a(wv.x, xv.w, s3);
        s3 = __dp4a(wv.y, xv.z, s3);
        s3 = __dp4a(wv.z, xv.y, s3);
        s3 = __dp4a(wv.w, xv.x, s3);
        s4 = __dp4a(wv.y, xv.w, s4);
        s4 = __dp4a(wv.z, xv.z, s4);
        s4 = __dp4a(wv.w, xv.y, s4);
        s5 = __dp4a(wv.z, xv.w, s5);
        s5 = __dp4a(wv.w, xv.z, s5);
        s6 = __dp4a(wv.w, xv.w, s6);
      }
      const int s[7] = {s0, s1, s2, s3, s4, s5, s6};
      uint32_t acc = 0;
#pragma unroll
      for (int q = 0; q < 7; ++q)
        acc = bb::add(acc, bb::mul((uint32_t)(s[q] + (int)kOffset), __ldg(consts + q)));
      res[k * (kTile + 1) + lane] = bb::sub(acc, __ldg(consts + 7));
    }
  }
  __syncthreads();

  for (int i = tid; i < total; i += nthreads) {
    int j, ln;
    coords(i, j, ln);
    const size_t pos = position(j, ln);
    uint32_t v = res[j * (kTile + 1) + ln];
    if (cross != nullptr) v = bb::mul(v, __ldg(cross + pos));
    out[base + pos] = v;
  }
}

void launch_pass(const uint32_t* x, uint32_t* out, const int4* w, const uint32_t* cross,
                 const uint32_t* consts, long long batch, int log_m, int log_l, int along_rows,
                 cudaStream_t stream) {
  const int tiles_log = log_l > 5 ? log_l - 5 : 0;
  const long long blocks = batch << tiles_log;
  mxu_dft_kernel<<<(unsigned)blocks, dim3(kTile, kRowsY), 0, stream>>>(x, out, w, cross, consts,
                                                                       log_m, log_l, along_rows);
}

}  // namespace
}  // namespace raiko

// B6 on `batch` rows of 2^(log_r + log_c) elements, x -> out (out may not
// alias x).  w_r, w_c: the packed R- and C-point DFT matrices ((M, G) int4
// words); cross: the (R, C) Montgomery cross twiddles; consts: b_0..b_6, K.
// log_r, log_c <= 7.
extern "C" int raiko_babybear_ntt_mxu(const void* x, void* out, const void* w_r, const void* w_c,
                                      const void* cross, const void* consts, long long batch,
                                      int log_r, int log_c, void* stream) {
  using namespace raiko;
  const cudaStream_t st = (cudaStream_t)stream;
  if (batch <= 0) return (int)cudaGetLastError();
  if (log_r < 0 || log_c < 0 || log_r > 7 || log_c > 7) return (int)cudaErrorInvalidValue;
  uint32_t* o = (uint32_t*)out;
  const uint32_t* k = (const uint32_t*)consts;
  launch_pass((const uint32_t*)x, o, (const int4*)w_r, (const uint32_t*)cross, k, batch, log_r,
              log_c, 0, st);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  launch_pass(o, o, (const int4*)w_c, nullptr, k, batch, log_c, log_r, 1, st);
  return (int)cudaGetLastError();
}
