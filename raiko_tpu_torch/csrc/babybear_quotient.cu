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
// Montgomery form, ACC + kind: fold alpha^dst * a into the numerator with
// the selector of the constraint kind (transition, first row, last row,
// all rows), or NOP.  An operand word holds its kind in the top four bits
// (an entry of the segment's column list or a value slot, each a place in
// a row's tile, or a scalar: the constant pool, the table's publics,
// challenge and bus coordinates, and the row-invariant values computed
// from them) and its index below.  Every value is canonical, so any order
// of the sums gives the reference's bits.
//
// The constraint rows are split into G segments, each with its own
// dependency closure (blockIdx.y), and the recorder schedules each segment
// as steps of L instructions that do not depend on each other (NOP where a
// step has fewer), its value slots allocated by liveness at step
// granularity: no instruction of a step writes a slot that another of the
// step reads or writes.  It closes a segment at about SEGMENT_STEPS steps,
// or where a warp's rows of it would stage more than WARP_TILE_WORDS words
// of columns and slots (quotient_tape.py).
//
// The design:
// * A group of L lanes (L = 1, 2, ..., 32: the least with L * m >= 4,096,
//   or more where a row's columns need it) walks one LDE row through a
//   segment, lane j taking instruction j of each step, then __syncwarp:
//   the groups of a warp walk the same steps on 32 / L rows.
//   The EVM CPU table's 128 rows take a warp each, so a 16,937-instruction
//   LogUp segment is 564 steps; the keccak chunk's 4,096 rows a lane each.
// * Nothing on the walk reads device memory.  Before it, a block stages
//   for its rows the segment's column list (local and next row, through
//   next_perm; cp.async) and its alpha powers, and copies the scalars: one
//   [row][column + slot] tile (an odd row stride, so 32 rows' lanes hit 32
//   banks) beside them in shared memory; an operand is one shared-memory
//   read.  The uniform values are computed once per call, by
//   quotient_uniform_kernel (one warp, a step of 32 independent values at
//   a time, in shared memory), into the scalars.
// * The tape is streamed: a producer warp keeps kStages chunks of kChunk
//   instructions in flight with TMA bulk copies (cp.async.bulk, an mbarrier
//   per stage), and each consumer warp frees a stage as it leaves it, so no
//   warp stops at a block-wide barrier for instructions.
// * At L > 1 the lanes of a step run different ops, so each forms every
//   result and selects one; at L = 1 a warp's lanes run the same one.
// * An ACC folds alpha^dst * sel_kind(row) * a into one sum a lane (the
//   row's four selectors are in registers); the L lanes of a row add their
//   sums by shuffles.  Each segment writes a partial numerator;
//   quotient_sum_kernel adds the G partials in a further launch.
//
// What bounds it: a step is a dependent chain (operands and slot in shared
// memory, a product, a store, __syncwarp), and the EVM CPU table's 128
// rows x 33 segments give a few warps an SM, the tile (up to 8 KB a warp)
// and the scalars limiting the blocks an SM holds; the longest segment's
// steps (564) times that chain, and the waves of blocks, bound a launch
// beside the instructions executed (0.21 ms on an H100 at 700 W, 3.5 ms
// with a thread a row).  At L = 1 (the keccak chunk, 0.64 ms) the
// instructions executed and the columns staged (each segment stages the
// columns it reads for its rows: 25,916 against 7,621 distinct) bound it.
// The uniform values' launch is a chain of one step a dependency level
// (303 on the EVM CPU table, some 29 us).  The least work, each distinct
// node of the graph once per row, is far below all of these.
#include <cuda_runtime.h>

#include <cstdint>

#include "babybear.cuh"

namespace raiko {
namespace quotient {

constexpr int kStages = 4;    // the tape ring's stages (quotient_tape.RING_STAGES)
constexpr int kChunk = 128;   // instructions a stage (quotient_tape.RING_CHUNK)
constexpr int kUniChunk = 2048;  // uniform instructions staged at a time
constexpr int kKindShift = 28;
constexpr uint32_t kIndexMask = (1u << kKindShift) - 1;
enum : uint32_t { kSlot, kLocal, kNext, kAux, kAuxNext, kFixed, kScalar, kColumn };
enum : int { kAdd, kSub, kMul, kAcc };
constexpr int kKinds = 4;
constexpr int kNop = kAcc + kKinds;
constexpr int kMaxThreads = 512 + 32;  // consumers and the producer warp

struct Columns {
  const uint32_t* trace;
  const uint32_t* aux;
  const uint32_t* fixed;
};

struct Segments {
  const int4* program;
  const int* offsets;      // (G + 1,) instructions
  const int* slots;        // (G,) value slots
  const uint32_t* cols;    // the column lists
  const int* col_offsets;  // (G + 1,)
  const int* rows;         // (G + 1,) constraint rows
};

// x op y for a lane of L: at L = 1 every lane of a warp runs the same
// instruction, so a branch costs one path; else every result is formed and
// one selected, so lanes with other ops do not diverge
template <int L>
__device__ __forceinline__ uint32_t apply(int op, uint32_t x, uint32_t y) {
  if (L == 1) {
    if (op == kMul) return bb::mul(x, y);
    return op == kAdd ? bb::add(x, y) : bb::sub(x, y);
  }
  const uint32_t s = bb::add(x, op == kSub ? bb::P - y : y);  // p - 0 = p: add(x, p) = x
  const uint32_t p = bb::mul(x, y);
  return op == kMul ? p : s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// The uniform values: scal holds the constant pool and the table's inputs;
// this computes uniform[u] = (op, dst, a, b) over it in place, in steps of
// 32 instructions that read only earlier steps (NOP where a level has
// fewer).  One block: warp 0 walks one staged chunk of the program while
// the other warps stage the next.  Dynamic shared memory: two chunks of
// kUniChunk instructions, then the n_scalars scalars.
__global__ void quotient_uniform_kernel(const int4* __restrict__ uniform, int n_uniform, uint32_t* __restrict__ scal_g,
                                        int n_scalars) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* prog = reinterpret_cast<int4*>(smem);
  uint32_t* scal = reinterpret_cast<uint32_t*>(prog + 2 * kUniChunk);
  const int tid = threadIdx.x;
  for (int i = tid; i < n_scalars; i += blockDim.x) scal[i] = scal_g[i];
  for (int i = tid; i < min(kUniChunk, n_uniform); i += blockDim.x) prog[i] = uniform[i];
  __syncthreads();
  for (int c0 = 0, k = 0; c0 < n_uniform; c0 += kUniChunk, ++k) {
    const int4* chunk = prog + (k & 1) * kUniChunk;
    if (tid < 32) {
      const int n = min(kUniChunk, n_uniform - c0);  // a multiple of 32
      int4 ins = chunk[tid];
      for (int pc = tid; pc < n; pc += 32) {
        const int4 nxt = pc + 32 < n ? chunk[pc + 32] : ins;
        if (ins.x < kAcc) scal[ins.y] = apply<32>(ins.x, scal[ins.z], scal[ins.w]);
        __syncwarp();
        ins = nxt;
      }
    } else {
      int4* next = prog + ((k + 1) & 1) * kUniChunk;
      const int c1 = c0 + kUniChunk;
      for (int i = c1 + tid - 32; i < min(c1 + kUniChunk, n_uniform); i += blockDim.x - 32) next[i - c1] = uniform[i];
    }
    __syncthreads();
  }
  for (int i = tid; i < n_scalars; i += blockDim.x) scal_g[i] = scal[i];
}

// Block (x, g): rows x * R .. x * R + R - 1 of segment g, L lanes a row,
// then one producer warp.  Dynamic shared memory: the tape ring, its
// barriers, the n_scalars scalars, then the segment's alpha powers and its
// [row][column + slot] tile, T words a row (odd).  out: (G, 4, m).
template <int L>
__global__ void __launch_bounds__(kMaxThreads)
    quotient_kernel(Segments sg, const uint32_t* __restrict__ scalars, int n_scalars, Columns cols,
                    const uint32_t* __restrict__ alpha, const long long* __restrict__ next_perm,
                    const uint32_t* __restrict__ sels, uint32_t* __restrict__ out, long long m, int log_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  int4* ring = reinterpret_cast<int4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kChunk);
  uint64_t* empty = full + kStages;
  uint32_t* scal = reinterpret_cast<uint32_t*>(empty + kStages);
  uint32_t* alpha_s = scal + ((n_scalars + 3) & ~3);
  const int R = 1 << log_rows;
  const int consumers = R * L;
  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int lo = sg.offsets[g];
  const int n_ins = sg.offsets[g + 1] - lo;
  const int n_chunks = (n_ins + kChunk - 1) / kChunk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= consumers) {  // the producer warp: one lane streams the tape
    if (tid == consumers) {
      for (int k = 0; k < n_chunks; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(&empty[s], ((k / kStages) - 1) & 1);
        const uint32_t bytes = 16u * min(kChunk, n_ins - k * kChunk);
        mbar_expect_tx(&full[s], bytes);
        tma_load(ring + s * kChunk, sg.program + lo + (long long)k * kChunk, bytes, &full[s]);
      }
    }
    return;
  }

  // stage the scalars, the segment's alpha powers and its columns
  const int rlo = sg.rows[g];
  const int n_rows = sg.rows[g + 1] - rlo;
  const int clo = sg.col_offsets[g];
  const int n_cols = sg.col_offsets[g + 1] - clo;
  const int T = (n_cols + sg.slots[g]) | 1;  // the tile's row stride
  uint32_t* tile = alpha_s + 4 * n_rows;
  const long long row0 = (long long)blockIdx.x << log_rows;
  for (int i = tid; i < n_scalars; i += consumers) cp_async4(scal + i, scalars + i);
  for (int i = tid; i < 4 * n_rows; i += consumers) cp_async4(alpha_s + i, alpha + 4LL * rlo + i);
  {
    // thread t stages row t % R of every (consumers / R)-th column from
    // column t / R: neighbouring threads read neighbouring rows
    const int rr = tid & (R - 1);
    const long long row = row0 + rr;
    if (row < m) {
      const long long nrow = next_perm[row];
      for (int j = tid >> log_rows; j < n_cols; j += consumers >> log_rows) {
        const uint32_t w = sg.cols[clo + j];
        const uint32_t kind = w >> kKindShift;
        const uint32_t* base = kind <= kNext ? cols.trace : kind <= kAuxNext ? cols.aux : cols.fixed;
        const long long at = (kind == kNext || kind == kAuxNext) ? nrow : row;
        cp_async4(tile + rr * T + j, base + (long long)(w & kIndexMask) * m + at);
      }
    }
  }
  // this row's selectors, one per constraint kind
  const int r = tid / L;
  const int lane = tid % L;
  const long long row = row0 + r;
  uint32_t sel[kKinds];
#pragma unroll
  for (int k = 0; k < kKinds; ++k) sel[k] = row < m ? sels[k * m + row] : 0;
  cp_async_wait_all();
  consumers_sync(consumers);

  // the walk: lane j of row r takes instruction j of each step.  An
  // operand is scal[i], or place i of the row's tile (the segment's
  // columns, then its slots): one shared-memory read either way.
  const int row_at = (int)(tile - scal) + r * T;
  uint32_t acc[4] = {0, 0, 0, 0};
  auto at = [&](uint32_t ref) -> int {
    return (int)(ref & kIndexMask) + ((ref >> kKindShift) == kScalar ? 0 : row_at);
  };
  for (int k = 0; k < n_chunks; ++k) {
    const int s = k % kStages;
    mbar_wait(&full[s], (k / kStages) & 1);
    const int4* chunk = ring + s * kChunk;
    const int n = min(kChunk, n_ins - k * kChunk);  // a multiple of L
    int4 ins = chunk[lane];
    for (int pc = lane; pc < n; pc += L) {
      const int4 nxt = pc + L < n ? chunk[pc + L] : ins;
      const uint32_t x = scal[at((uint32_t)ins.z)];
      if (ins.x < kAcc) {
        scal[row_at + ins.y] = apply<L>(ins.x, x, scal[at((uint32_t)ins.w)]);
      } else if (ins.x < kNop) {
        // alpha^dst * sel_kind(row) * x, into the row's one sum
        const int kind = ins.x - kAcc;
        const uint32_t sk = kind == 0 ? sel[0] : kind == 1 ? sel[1] : kind == 2 ? sel[2] : sel[3];
        const uint32_t xs = bb::mul(x, sk);
        const uint4 ap = *reinterpret_cast<const uint4*>(alpha_s + 4 * (ins.y - rlo));
        acc[0] = bb::add(acc[0], bb::mul(ap.x, xs));
        acc[1] = bb::add(acc[1], bb::mul(ap.y, xs));
        acc[2] = bb::add(acc[2], bb::mul(ap.z, xs));
        acc[3] = bb::add(acc[3], bb::mul(ap.w, xs));
      }
      if (L > 1) __syncwarp();  // one lane a row reads only its own row's slots
      ins = nxt;
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&empty[s]);
  }

  // the L lanes of a row add their sums
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = bb::add(acc[c], __shfl_xor_sync(0xffffffffu, acc[c], off));
  }
  if (lane == 0 && row < m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[((long long)g * 4 + c) * m + row] = acc[c];
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

template <int L>
int launch(const Segments& sg, const uint32_t* scalars, int n_scalars, const Columns& cols, const uint32_t* alpha,
           const long long* next_perm, const uint32_t* sels, uint32_t* out, long long m, int segments,
           int log_rows, int blocks, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(quotient_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (L << log_rows) + 32;
  quotient_kernel<L><<<dim3((unsigned)blocks, (unsigned)segments), threads, smem, stream>>>(
      sg, scalars, n_scalars, cols, alpha, next_perm, sels, out, m, log_rows);
  return (int)cudaGetLastError();
}

}  // namespace quotient
}  // namespace raiko

// The uniform values of one call, computed in place into scalars (its
// first entries the constant pool and the table's inputs), in one block
// with `smem` bytes of dynamic shared memory (ops/quotient_cuda.py sizes
// it).
extern "C" int raiko_babybear_quotient_uniform(const void* uniform, void* scalars, int n_uniform, int n_scalars,
                                               int smem, void* stream) {
  if (n_uniform > 0) {
    cudaError_t err = cudaFuncSetAttribute(raiko::quotient::quotient_uniform_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    raiko::quotient::quotient_uniform_kernel<<<1, 256, smem, (cudaStream_t)stream>>>(
        (const int4*)uniform, n_uniform, (uint32_t*)scalars, n_scalars);
  }
  return (int)cudaGetLastError();
}

// The (segments, 4, m) numerators of a tape's segments over m LDE rows,
// `lanes` lanes a row and 2^log_rows rows a block over `blocks` blocks a
// segment, with `smem` bytes of dynamic shared memory
// (ops/quotient_cuda.py sizes both).
extern "C" int raiko_babybear_quotient(const void* program, const void* seg_offsets, const void* seg_slots,
                                       const void* seg_cols, const void* seg_col_offsets, const void* seg_rows,
                                       const void* scalars,
                                       const void* trace, const void* aux, const void* fixed, const void* alpha,
                                       const void* next_perm, const void* sels, void* out, int n_scalars,
                                       long long m, int segments, int lanes, int log_rows, int blocks, int smem,
                                       void* stream) {
  using namespace raiko::quotient;
  if (m <= 0 || segments <= 0) return (int)cudaGetLastError();
  const Segments sg{(const int4*)program, (const int*)seg_offsets, (const int*)seg_slots, (const uint32_t*)seg_cols,
                    (const int*)seg_col_offsets, (const int*)seg_rows};
  const Columns cols{(const uint32_t*)trace, (const uint32_t*)aux, (const uint32_t*)fixed};
  const auto* sc = (const uint32_t*)scalars;
  const auto* al = (const uint32_t*)alpha;
  const auto* np = (const long long*)next_perm;
  const auto* se = (const uint32_t*)sels;
  auto* o = (uint32_t*)out;
  const auto st = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch<1>(sg, sc, n_scalars, cols, al, np, se, o, m, segments, log_rows, blocks, smem, st);
    case 2: return launch<2>(sg, sc, n_scalars, cols, al, np, se, o, m, segments, log_rows, blocks, smem, st);
    case 4: return launch<4>(sg, sc, n_scalars, cols, al, np, se, o, m, segments, log_rows, blocks, smem, st);
    case 8: return launch<8>(sg, sc, n_scalars, cols, al, np, se, o, m, segments, log_rows, blocks, smem, st);
    case 16: return launch<16>(sg, sc, n_scalars, cols, al, np, se, o, m, segments, log_rows, blocks, smem, st);
    case 32: return launch<32>(sg, sc, n_scalars, cols, al, np, se, o, m, segments, log_rows, blocks, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
