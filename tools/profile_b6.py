#!/usr/bin/env python3
"""Where kernel B6's time goes on the card: B6 against copies of its source
with parts taken out, and the peak rate of the int8 ``mma.sync`` it runs on.

    python3 tools/profile_b6.py                 # this checkout
    python3 tools/profile_b6.py --root DIR      # another checkout's raiko_tpu_torch

Each variant is the checkout's csrc/babybear_ntt_mxu.cu built with one
value of its switch RAIKO_MXU_PROFILE, by nvcc into its own library under
raiko_tpu_torch/_build/profile_b6/, and timed as a CUDA graph of calls at
4,160 x 4,096 (the keccak chunk's LDE) and 64 x 2^14; only the kernel's
output is checked (against B5's ``ntt``), the others compute garbage by
design:

    kernel           the source as it is
    no_epilogue      the recombination and the stores replaced by a store
                     that never happens (the products must still finish)
    products_only    no_epilogue, and the digit conversion (loads included)
                     skipped: the IMMA and what issues them
    conversion_only  the DFT passes skipped: loads, conversion, barriers

The microbenchmark runs 528 blocks of warps that each issue ``chains``
independent accumulations of mma.sync.m16n8k32.s8 (2,000 rounds) and
reports the m16n8k32 per clock per SM at the card's maximum SM clock and
the rate in int8 operations per second.  Each result is one JSON line;
the first line is nvidia-smi's name and power limit.  Needs one CUDA card
and nvcc; JAX and the JAX package are refused.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

from kernel_timing import emit, graph_ms

from chip_smoke import KECCAK_COLS, KECCAK_ROWS, SEED

VARIANTS = {"kernel": 0, "no_epilogue": 1, "products_only": 2, "conversion_only": 3}  # RAIKO_MXU_PROFILE

MMA_BENCH = r"""
#include <cstdio>
#include <cuda_runtime.h>
template <int CHAINS>
__global__ void imma(int* out, int iters) {
  int d[CHAINS][4] = {};
  unsigned a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7, b0 = a0 * 11, b1 = a0 * 13;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
                   "{%0,%1,%2,%3};"
                   : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int s = 0;
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int CHAINS>
void run(int* buf, int warps) {
  const int iters = 2000, blocks = 528;
  imma<CHAINS><<<blocks, 32 * warps>>>(buf, 10);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  imma<CHAINS><<<blocks, 32 * warps>>>(buf, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  printf("%d %d %d %.6f %s\n", CHAINS, warps, blocks, ms, cudaGetErrorString(cudaGetLastError()));
}
int main() {
  int* buf;
  cudaMalloc(&buf, 1 << 24);
  run<1>(buf, 4);
  run<4>(buf, 4);
  run<8>(buf, 8);
  return 0;
}
"""


def nvcc() -> str:
    from raiko_tpu_torch import kernels

    return kernels._nvcc()


def build_variant(csrc: str, out_dir: str, name: str, profile: int) -> ctypes.CDLL:
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
                    "-fPIC", "-shared", f"-DRAIKO_MXU_PROFILE={profile}", "-o", lib,
                    os.path.join(csrc, "babybear_ntt_mxu.cu")], check=True, capture_output=True)
    so = ctypes.CDLL(lib)
    so.raiko_babybear_ntt_mxu.argtypes = 6 * [ctypes.c_void_p] + [ctypes.c_longlong] + 2 * [ctypes.c_int] + [
        ctypes.c_void_p]
    so.raiko_babybear_ntt_mxu.restype = ctypes.c_int
    return so


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        help="checkout whose raiko_tpu_torch to profile")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_b6: torch sees no CUDA device")
    smi = lambda q: subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"], capture_output=True,
                                   text=True, check=True).stdout.strip().splitlines()[0]
    print(smi("name,power.limit"), flush=True)
    max_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sys.path.insert(0, os.path.abspath(args.root))
    from raiko_tpu_torch import convert
    from raiko_tpu_torch.fields import babybear as bb
    from raiko_tpu_torch.ops import ntt_cuda, ntt_mxu, ntt_mxu_cuda

    out_dir = os.path.join(os.path.abspath(args.root), "raiko_tpu_torch", "_build", "profile_b6")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(os.path.abspath(args.root), "raiko_tpu_torch", "csrc")

    bench = os.path.join(out_dir, "mma_bench")
    with open(bench + ".cu", "w") as f:
        f.write(MMA_BENCH)
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", bench, bench + ".cu"],
                   check=True, capture_output=True)
    for line in subprocess.run([bench], capture_output=True, text=True, check=True).stdout.splitlines():
        chains, warps, blocks, ms, err = line.split(maxsplit=4)
        mmas = int(blocks) * int(warps) * 2000 * int(chains)
        emit(bench="mma.sync.m16n8k32.s8", chains_per_warp=int(chains), warps_per_block=int(warps),
             blocks=int(blocks), ms=float(ms), mma_per_clock_per_sm=mmas / (float(ms) * 1e-3) / sms / max_hz,
             int8_ops_per_s=mmas * 2 * 16 * 8 * 32 / (float(ms) * 1e-3), error=err)

    rng = np.random.default_rng(SEED)
    libs = {name: build_variant(csrc, out_dir, name, profile) for name, profile in VARIANTS.items()}
    for bsz, log_n in ((KECCAK_COLS, (4 * KECCAK_ROWS).bit_length() - 1), (64, 14)):
        x = convert.words_from_numpy(bb.np_to_mont(rng.integers(0, bb.P, (bsz, 1 << log_n), dtype=np.uint32)),
                                     "cuda")
        log_r, log_c = ntt_mxu._split(1 << log_n)
        w_r, w_c, cross = ntt_mxu_cuda._tables(log_r, log_c, x.device)
        out = torch.empty_like(x)
        scratch = torch.empty_like(x)
        row = {"shape": [bsz, 1 << log_n]}
        for name, so in libs.items():
            def call(so=so):
                err = so.raiko_babybear_ntt_mxu(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), w_r.data_ptr(),
                                                w_c.data_ptr(), cross.data_ptr(), bsz, log_r, log_c,
                                                torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"profile_b6: {name}: CUDA error {err}")
            row[f"{name}_ms"] = graph_ms(call, 10)
            if name == "kernel":
                call()
                row["kernel_equal_b5"] = bool(torch.equal(out, ntt_cuda.ntt(x)))
        emit(**row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
