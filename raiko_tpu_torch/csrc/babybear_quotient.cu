// Q1: the STARK quotient stage's constraint evaluation for Hopper (sm_90a),
// an interpreter of each AIR's recorded constraint tape over the LDE rows.
//
// Counterpart of the XLA program the JAX package compiles per AIR for its
// quotient (raiko_tpu/stark/prover.py _quotient_stage_for: the jax.jit qfn,
// and the host-numpy route of its eager_quotient AIRs); there is no Pallas
// kernel for it.  Before it, the port ran every AIR's constraints op by op,
// one torch launch per algebra call: some 63,000 launches for the EVM CPU
// table, whose arithmetic per row is a few microseconds.
//
// The tape (raiko_tpu_torch/stark/quotient_tape.py) is a program of int4
// instructions (op, dst, a, b): slot[dst] = a + b, a - b or a * b in
// Montgomery form, or ACC + kind: add alpha^dst * a to the accumulator of
// the constraint kind (transition, first row, last row, all rows).  An
// operand word holds its kind in the top four bits (a slot, a column of the
// trace LDE, the same column at the next row through next_perm, an aux or
// aux-next column, a fixed column, or a scalar: the constant pool, the
// table's publics, challenge and bus coordinates, and the row-invariant
// values computed from them) and its index below.  Every value is canonical, so any order of the sums gives the
// reference's bits.
//
// What bounds it on the card, and the design:
// * The work is the tape's instructions times the rows: for the EVM CPU
//   table 141,663 products and sums (after the recorder's CSE) per row, and
//   11,872 constraint rows to fold, each four products by alpha's power.
//   At a full card's 16.7 T 32-bit integer operations a second that is a
//   few microseconds for its 128 rows; the columns' bytes are less.  An
//   interpreter is far from that: each instruction is a dependent chain of
//   a tape read, operand reads and a write of its slot, so its latency
//   bounds a thread, and a table has few rows to spread.
// * A thread evaluates one LDE row through one segment of the tape.  The
//   block stages its segment's instructions through shared memory
//   (kChunk at a time), so every lane reads the same instruction there (a
//   broadcast, no divergence); column loads are coalesced over rows
//   (column * m + row), the next row's through next_perm.
// * Slots: a shared-memory tile [slot][thread], conflict-free; the
//   recorder allocates them by liveness and caps a segment at 1,024 (the
//   EVM CPU table's segments need 141 at most), and the wrapper takes 128,
//   64 or 32 threads a block, the most whose tile fits.
// * Scalars: the block copies the constant pool and the table's publics,
//   challenge and bus coordinates into shared memory, then computes the
//   row-invariant nodes there, one dependency level at a time (297 levels,
//   2,928 nodes for the EVM CPU table), once per launch and block, never
//   per row.
// * Occupancy: an EVM table has only a few hundred LDE rows, too few
//   threads to fill 132 SMs.  So the constraint rows are split into G
//   segments, each with its own dependency closure (blockIdx.y), and each
//   segment writes a partial numerator; quotient_sum_kernel adds the G
//   partials in a second launch.  G = ceil(2^20 / m), at most 256 and at
//   most the constraint rows.  A constraint row that alone needs a G-th of
//   the tape gets a segment of its own: the EVM CPU table's eight LogUp
//   transitions need some 17,000 instructions each, and one thread's walk
//   through the longest segment bounds the launch.
// * Accumulators: one extension-field sum per constraint kind (16 u32 in
//   registers); each kind's selector multiplies its sum once per row.
#include <cuda_runtime.h>

#include <cstdint>

#include "babybear.cuh"

namespace raiko {
namespace quotient {

constexpr int kChunk = 256;  // instructions staged in shared memory at a time
constexpr int kKindShift = 28;
constexpr uint32_t kIndexMask = (1u << kKindShift) - 1;
enum : uint32_t { kSlot, kLocal, kNext, kAux, kAuxNext, kFixed, kScalar };
enum : int { kAdd, kSub, kMul, kAcc };
constexpr int kKinds = 4;

struct Columns {
  const uint32_t* trace;
  const uint32_t* aux;
  const uint32_t* fixed;
};

__device__ __forceinline__ uint32_t apply(int op, uint32_t x, uint32_t y) {
  return op == kAdd ? bb::add(x, y) : op == kSub ? bb::sub(x, y) : bb::mul(x, y);
}

__device__ __forceinline__ uint32_t fetch(uint32_t ref, const Columns& c, long long m, long long row,
                                          long long nrow, const uint32_t* scal, const uint32_t* slots) {
  const long long i = ref & kIndexMask;
  switch (ref >> kKindShift) {
    case kSlot:
      return slots[i * blockDim.x];
    case kLocal:
      return c.trace[i * m + row];
    case kNext:
      return c.trace[i * m + nrow];
    case kAux:
      return c.aux[i * m + row];
    case kAuxNext:
      return c.aux[i * m + nrow];
    case kFixed:
      return c.fixed[i * m + row];
    default:
      return scal[i];
  }
}

// Block (x, g) evaluates rows x * blockDim.x + threadIdx.x, then that plus
// gridDim.x * blockDim.x, ..., through segment g.  Dynamic shared memory:
// the instruction chunk, the n_scalars scalars, the slots x blockDim.x tile.
// out: (G, 4, m).
__global__ void quotient_kernel(const int4* __restrict__ program, const int* __restrict__ seg_offsets,
                                const int4* __restrict__ uniform, const int* __restrict__ uniform_levels,
                                int n_levels, const uint32_t* __restrict__ scalars_in, int n_in, int n_scalars,
                                Columns cols, const uint32_t* __restrict__ alpha,
                                const long long* __restrict__ next_perm, const uint32_t* __restrict__ sels,
                                uint32_t* __restrict__ out, long long m) {
  extern __shared__ int4 smem[];
  int4* chunk = smem;
  uint32_t* scal = reinterpret_cast<uint32_t*>(smem + kChunk);
  uint32_t* slots = scal + ((n_scalars + 3) & ~3) + threadIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;

  for (int i = tid; i < n_in; i += blockDim.x) scal[i] = scalars_in[i];
  __syncthreads();
  for (int l = 0; l < n_levels; ++l) {
    for (int u = uniform_levels[l] + tid; u < uniform_levels[l + 1]; u += blockDim.x) {
      const int4 ins = __ldg(uniform + u);
      scal[ins.y] = apply(ins.x, scal[ins.z], scal[ins.w]);
    }
    __syncthreads();
  }

  const int lo = seg_offsets[g];
  const int hi = seg_offsets[g + 1];
  for (long long base = (long long)blockIdx.x * blockDim.x; base < m; base += (long long)gridDim.x * blockDim.x) {
    const long long row = base + tid;
    const bool live = row < m;
    const long long nrow = live ? next_perm[row] : 0;
    uint32_t acc[kKinds][4];
#pragma unroll
    for (int k = 0; k < kKinds; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[k][c] = 0;
    }
    for (int c0 = lo; c0 < hi; c0 += kChunk) {
      const int n = min(kChunk, hi - c0);
      __syncthreads();  // the previous chunk is read by every thread
      for (int i = tid; i < n; i += blockDim.x) chunk[i] = __ldg(program + c0 + i);
      __syncthreads();
      if (!live) continue;
      for (int pc = 0; pc < n; ++pc) {
        const int4 ins = chunk[pc];
        const uint32_t x = fetch((uint32_t)ins.z, cols, m, row, nrow, scal, slots);
        if (ins.x >= kAcc) {
          const uint32_t* ap = alpha + 4LL * ins.y;
          uint32_t term[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) term[c] = bb::mul(__ldg(ap + c), x);
#pragma unroll
          for (int k = 0; k < kKinds; ++k) {
            if (ins.x - kAcc == k) {
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[k][c] = bb::add(acc[k][c], term[c]);
            }
          }
        } else {
          slots[ins.y * blockDim.x] =
              apply(ins.x, x, fetch((uint32_t)ins.w, cols, m, row, nrow, scal, slots));
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < kKinds; ++k) v = bb::add(v, bb::mul(acc[k][c], sels[k * m + row]));
      out[((long long)g * 4 + c) * m + row] = v;
    }
  }
}

// out[i] = sum over g of partial[g * n + i]
__global__ void quotient_sum_kernel(const uint32_t* __restrict__ partial, uint32_t* __restrict__ out,
                                    int segments, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t v = 0;
  for (int g = 0; g < segments; ++g) v = bb::add(v, partial[(long long)g * n + i]);
  out[i] = v;
}

}  // namespace quotient
}  // namespace raiko

// The (segments, 4, m) numerators of a tape's segments over m LDE rows,
// with `threads` threads a block over `blocks` blocks a segment and `smem`
// bytes of dynamic shared memory (ops/quotient_cuda.py sizes both).
extern "C" int raiko_babybear_quotient(const void* program, const void* seg_offsets, const void* uniform,
                                       const void* uniform_levels, const void* scalars_in, const void* trace,
                                       const void* aux, const void* fixed, const void* alpha, const void* next_perm,
                                       const void* sels, void* out, int n_levels, int n_in, int n_scalars,
                                       long long m, int segments, int threads, int blocks, int smem, void* stream) {
  if (m > 0 && segments > 0) {
    cudaError_t err = cudaFuncSetAttribute(raiko::quotient::quotient_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const raiko::quotient::Columns cols{(const uint32_t*)trace, (const uint32_t*)aux, (const uint32_t*)fixed};
    const dim3 grid((unsigned)blocks, (unsigned)segments);
    raiko::quotient::quotient_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const int4*)program, (const int*)seg_offsets, (const int4*)uniform, (const int*)uniform_levels, n_levels,
        (const uint32_t*)scalars_in, n_in, n_scalars, cols, (const uint32_t*)alpha, (const long long*)next_perm,
        (const uint32_t*)sels, (uint32_t*)out, m);
  }
  return (int)cudaGetLastError();
}

// out (n,) = the sum of the (segments, n) partials
extern "C" int raiko_babybear_quotient_sum(const void* partial, void* out, int segments, long long n,
                                           void* stream) {
  if (n > 0) {
    const int threads = 256;
    raiko::quotient::quotient_sum_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                                           (cudaStream_t)stream>>>((const uint32_t*)partial, (uint32_t*)out,
                                                                   segments, n);
  }
  return (int)cudaGetLastError();
}
