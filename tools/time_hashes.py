#!/usr/bin/env python3
"""Time the Keccak-f[1600] and SHA-256 kernels on the card, against copies
of their sources with parts switched off, and the latency of the dependent
integer instructions their chains are made of.

    python3 tools/time_hashes.py                      # this checkout
    python3 tools/time_hashes.py --root DIR           # another checkout's raiko_tpu_torch

keccak_f1600 runs on 1,024 to 131,072 random states, its absorbing form
(``keccak256_blocks``) on 8,192 to 131,072 messages of 32-532 bytes (one
to four rate blocks, MPT-node sized, as chip_smoke.py's phase ``ops``);
sha256_compress on 1,024 to 131,072 48-byte messages (one block each) and
on as many messages of 0-299 bytes (one to five blocks), the 1,024 to
16,384 mixes also sorted by length.  Each is timed through its wrapper as
a CUDA graph of back-to-back calls (``graph_ms``, the card's time per
call), the CUDA-event mean beside it, and, where a checkout's wrapper
offers layouts, in each layout.

Where the checkout's sources take RAIKO_HASH_PROFILE, each is also built
with it set, by nvcc into its own library under
raiko_tpu_torch/_build/time_hashes/, and the C entries of the copies are
timed side by side as graphs (``VARIANTS``):

    kernel               the source as it is
    unordered            the messages of a block of threads taken in their
                         own order, not by block count (both hashes)
    no_exchange          Keccak: each exchange of the pair's round replaced
                         by a local byte permutation (wrong states)
    stamped              Keccak: the first pair of each warp stamps its
                         permutation: clocks (clock64) and nanoseconds
                         (globaltimer) over the 24 rounds, nanoseconds
                         loading and interleaving, and de-interleaving and
                         storing, and its entry and end on the card's clock
                         (the kernel's span and the spread of the warps'
                         starts); read back as per-warp statistics
    stamped_no_exchange  both of the last two

The ordered and unordered copies' digests are compared with the wrapper's;
the other checks against the plain versions are chip_smoke.py's.

The probe runs one warp of single-instruction chains (LOP3, SHF, IADD3,
SHFL; each step depends on the last) and of eight independent LOP3 or
SHFL chains, and reports clocks per instruction from ``clock64``, with the
number of each probed instruction in the probe's SASS: a dependent chain's
latency, and the rate at which a warp alone on a scheduler issues.  The
hash kernels' SASS is counted by opcode (``cuobjdump -sass``), with each
loop's body apart (a Keccak round, a SHA-256 block), and the floor of a
launch in a graph is timed on a one-element add.

Each result is one JSON line; the first line is nvidia-smi's name and
power limit.  Needs one CUDA card and nvcc; JAX and the JAX package are
refused.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess
import sys

from kernel_timing import cuda_ms as events_ms, emit, graph_ms, start

from chip_smoke import SEED

STATE_WIDTHS = (1024, 4096, 8192, 16384, 32768, 65536, 131072)
NODE_COUNTS = (8192, 16384, 32768, 65536, 131072)
SHA_WIDTHS = (1024, 4096, 8192, 16384, 32768, 65536, 131072)
SORTED_MAX = 16384  # the 0-299-byte mixes also timed sorted by length, up to this width
STAMP_WIDTHS = (1024, 8192, 131072)  # the stamped and no-exchange copies
# copy -> (source, RAIKO_HASH_PROFILE)
VARIANTS = {
    "keccak_kernel": ("keccak_f1600.cu", 0), "keccak_unordered": ("keccak_f1600.cu", 1),
    "keccak_no_exchange": ("keccak_f1600.cu", 2), "keccak_stamped": ("keccak_f1600.cu", 4),
    "keccak_stamped_no_exchange": ("keccak_f1600.cu", 6),
    "sha256_kernel": ("sha256.cu", 0), "sha256_unordered": ("sha256.cu", 1),
}

PROBE_STEPS = 512
PROBE = r"""
#include <cstdio>
#include <cuda_runtime.h>
#define STEPS %(steps)d
#define CHAIN(name, body)                                                        \
  __global__ void name(const unsigned* in, unsigned* out, long long* clk) {     \
    unsigned d = in[threadIdx.x], b = in[32], c = in[33], s = in[34];           \
    __syncwarp();                                                               \
    const long long t0 = clock64();                                             \
    _Pragma("unroll") for (int i = 0; i < STEPS; ++i) { body; }                 \
    out[threadIdx.x] = d;                                                       \
    const long long t1 = clock64();                                             \
    if (threadIdx.x == 0) *clk = t1 - t0;                                       \
  }
CHAIN(lop3_chain, asm volatile("lop3.b32 %%0, %%0, %%1, %%2, 0xE8;" : "+r"(d) : "r"(b), "r"(c)))
CHAIN(shf_chain, asm volatile("shf.l.wrap.b32 %%0, %%0, %%0, %%1;" : "+r"(d) : "r"(s)))
CHAIN(iadd3_chain, asm volatile("add.u32 %%0, %%0, %%1;" : "+r"(d) : "r"(b)))
CHAIN(shfl_chain, d = __shfl_xor_sync(0xffffffffu, d, 1))
__global__ void lop3_issue(const unsigned* in, unsigned* out, long long* clk) {
  unsigned d[8], b = in[32], c = in[33];
  for (int k = 0; k < 8; ++k) d[k] = in[threadIdx.x] + k;
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll
  for (int i = 0; i < STEPS / 8; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) asm volatile("lop3.b32 %%0, %%0, %%1, %%2, 0xE8;" : "+r"(d[k]) : "r"(b), "r"(c));
  unsigned x = 0;
  for (int k = 0; k < 8; ++k) x ^= d[k];
  out[threadIdx.x] = x;
  const long long t1 = clock64();
  if (threadIdx.x == 0) *clk = t1 - t0;
}
__global__ void shfl_issue(const unsigned* in, unsigned* out, long long* clk) {
  unsigned d[8];
  for (int k = 0; k < 8; ++k) d[k] = in[threadIdx.x] + k;
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll
  for (int i = 0; i < STEPS / 8; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = __shfl_xor_sync(0xffffffffu, d[k], 1);
  unsigned x = 0;
  for (int k = 0; k < 8; ++k) x ^= d[k];
  out[threadIdx.x] = x;
  const long long t1 = clock64();
  if (threadIdx.x == 0) *clk = t1 - t0;
}
typedef void (*Probe)(const unsigned*, unsigned*, long long*);
int main() {
  unsigned host[35];
  for (int i = 0; i < 32; ++i) host[i] = 0x9E3779B9u * (i + 1);
  host[32] = 0xFFFF0000u; host[33] = 0x0000FFFFu; host[34] = 7;
  unsigned *in, *out; long long* clk;
  cudaMalloc(&in, sizeof host); cudaMalloc(&out, 32 * sizeof(unsigned)); cudaMalloc(&clk, sizeof(long long));
  cudaMemcpy(in, host, sizeof host, cudaMemcpyHostToDevice);
  const char* names[] = {"lop3_chain", "shf_chain", "iadd3_chain", "shfl_chain", "lop3_issue", "shfl_issue"};
  Probe probes[] = {lop3_chain, shf_chain, iadd3_chain, shfl_chain, lop3_issue, shfl_issue};
  for (int p = 0; p < 6; ++p) {
    long long best = -1;
    for (int rep = 0; rep < 5; ++rep) {
      probes[p]<<<1, 32>>>(in, out, clk);
      long long c;
      cudaMemcpy(&c, clk, sizeof c, cudaMemcpyDeviceToHost);
      if (best < 0 || c < best) best = c;
    }
    printf("%%s %%lld %%s\n", names[p], best, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
"""
# the SASS opcode each probe runs STEPS of (its count in the probe's SASS is
# reported beside the clocks: the assembler may fuse steps)
PROBE_OPS = {"lop3_chain": "LOP3", "shf_chain": "SHF", "iadd3_chain": "IADD3", "shfl_chain": "SHFL",
             "lop3_issue": "LOP3", "shfl_issue": "SHFL"}


def sass(path: str, want) -> dict[str, list[tuple[int, str]]]:
    """{function: [(address, instruction)]} for the functions of the binary
    at `path` whose name contains one of `want` (``cuobjdump -sass``)."""
    from raiko_tpu_torch import kernels

    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True, check=True).stdout
    funcs: dict[str, list[tuple[int, str]]] = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if any(w in name for w in want) else None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name is not None and m:
            funcs.setdefault(name, []).append((int(m.group(1), 16), m.group(2)))
    return funcs


def opcodes(instructions) -> collections.Counter:
    """Counter of the opcodes (without modifiers or predicates)."""
    ops = (t.split()[1] if t.startswith("@") else t.split()[0] for _, t in instructions)
    return collections.Counter(op.split(".")[0] for op in ops)


def loops(instructions) -> list[dict]:
    """Each innermost-looking loop (a backward branch over fewer than 2,000
    instructions): its address range and opcode counts."""
    out = []
    for addr, text in instructions:
        m = re.search(r"BRA(?:\.\w+)* (?:\w+, )?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            body = [x for x in instructions if int(m.group(1), 16) <= x[0] <= addr]
            if len(body) < 2000:
                ops = opcodes(body)
                out.append({"from": hex(body[0][0]), "to": hex(addr), "total": len(body),
                            "opcodes": dict(ops.most_common(8))})
    return out


def run_probe(root: str) -> None:
    from raiko_tpu_torch import kernels

    out_dir = os.path.join(root, "raiko_tpu_torch", "_build", "time_hashes")
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, "latency_probe")
    with open(exe + ".cu", "w") as f:
        f.write(PROBE % {"steps": PROBE_STEPS})
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", exe, exe + ".cu"],
                   check=True, capture_output=True)
    counts = {fn: opcodes(ins) for fn, ins in sass(exe, tuple(PROBE_OPS)).items()}
    for line in subprocess.run([exe], capture_output=True, text=True, check=True).stdout.splitlines():
        name, clocks, err = line.split(maxsplit=2)
        op = PROBE_OPS[name]
        n_sass = next((c[op] for fn, c in counts.items() if name in fn), 0)
        emit(probe=name, opcode=op, steps=PROBE_STEPS, sass_count=n_sass, clocks=int(clocks),
             clocks_per_step=int(clocks) / PROBE_STEPS,
             clocks_per_sass=int(clocks) / n_sass if n_sass else None, error=err)


def stamps(out) -> dict:
    """What the stamped Keccak copies wrote over the first state of each
    warp (16 states): per-warp mean, min and max of each stamp, the SM clock
    over the rounds, and the kernel's span from the first warp's entry to
    the last warp's stores."""
    import numpy as np

    s = out[::16, :3, :].cpu().numpy().view(np.uint32).astype(np.int64)
    stat = lambda v: {"mean": float(v.mean()), "min": float(v.min()), "max": float(v.max())}
    entry, end = s[:, 2, 0], s[:, 2, 1]
    rel = lambda v: (v - entry[0] + (1 << 31)) % (1 << 32) - (1 << 31)  # the low words, unwrapped
    return {"clocks_a_round": stat(s[:, 0, 0] / 24), "ns_a_round": stat(s[:, 0, 1] / 24),
            "sm_ghz": float(s[:, 0, 0].sum() / s[:, 0, 1].sum()), "load_ns": stat(s[:, 1, 0]),
            "store_ns": stat(s[:, 1, 1]), "entry_spread_ns": float(rel(entry).max() - rel(entry).min()),
            "span_ns": float(rel(end).max() - rel(entry).min())}


def build_variants(root: str) -> dict[str, ctypes.CDLL]:
    """The copies of VARIANTS whose source takes RAIKO_HASH_PROFILE, built in
    parallel (one nvcc each); {} for a checkout whose sources do not."""
    from raiko_tpu_torch import kernels

    csrc = os.path.join(root, "raiko_tpu_torch", "csrc")
    out_dir = os.path.join(root, "raiko_tpu_torch", "_build", "time_hashes")
    wanted = {}
    for name, (src, profile) in VARIANTS.items():
        with open(os.path.join(csrc, src)) as f:
            if "RAIKO_HASH_PROFILE" in f.read():
                wanted[name] = (src, profile)
    procs = {}
    for name, (src, profile) in wanted.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", f"-DRAIKO_HASH_PROFILE={profile}", "-o", lib,
             os.path.join(csrc, src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"time_hashes: nvcc failed on {name}:\n{log[-4000:]}")
        so = ctypes.CDLL(lib)
        entry = "raiko_keccak_f1600" if name.startswith("keccak") else "raiko_sha256_compress"
        fn = getattr(so, entry)
        fn.argtypes = kernels._ENTRIES[entry] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    args = start(__doc__)
    import numpy as np
    import torch

    from raiko_tpu_torch import convert, kernels
    from raiko_tpu_torch.ops import keccak, keccak_cuda, sha256, sha256_cuda

    label = args.label
    root = os.path.abspath(args.root)
    os.makedirs(os.path.join(root, "raiko_tpu_torch", "_build", "time_hashes"), exist_ok=True)
    run_probe(root)
    for fn, ins in sass(kernels.BUILD_INFO["path"], ("keccak", "sha256")).items():
        emit(sass=fn, label=label, total=len(ins), opcodes=dict(opcodes(ins).most_common()), loops=loops(ins))
    copies = build_variants(root)

    def copy(name: str, *c_args):
        """A call of copy `name`'s C entry; tensors pass their pointers."""
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in c_args]
        err = copies[name](*ptrs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"time_hashes: {name}: CUDA error {err}")

    # the floor of any launch in a graph: one add on a one-element tensor
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    emit(floor="one-element add", label=label, graph_ms=graph_ms(lambda: one.add_(1), 20))

    rng = np.random.default_rng(SEED)
    k_layouts = getattr(keccak_cuda, "LANE_CHOICES", ())
    s_layouts = getattr(sha256_cuda, "LAYOUTS", ())

    def timed(kernel: str, shape, fn, layouts=(), layout_fn=None, **extra) -> None:
        row = dict(kernel=kernel, label=label, shape=list(shape), graph_ms=graph_ms(fn, 20),
                   events_ms=events_ms(fn, 20), **extra)
        for lay in layouts:
            row[f"graph_ms_{lay}"] = graph_ms(lambda: layout_fn(lay), 20)
        emit(**row)

    states = convert.words_from_numpy(rng.integers(0, 1 << 32, (STATE_WIDTHS[-1], 25, 2), dtype=np.uint32), "cuda")
    for b in STATE_WIDTHS:
        st = states[:b]
        timed("keccak_f1600", st.shape, lambda: keccak_cuda.keccak_f1600(st))
        if "keccak_stamped" in copies and b in STAMP_WIDTHS:
            # the pair's round with and without its exchanges: graph times of
            # the copies, and clocks a round from the stamped ones
            rc = keccak_cuda._round_constants(st.device, 2)
            out = torch.empty_like(st)
            row = dict(kernel="keccak_f1600 copies", label=label, shape=list(st.shape))
            for name in ("keccak_kernel", "keccak_no_exchange", "keccak_stamped", "keccak_stamped_no_exchange"):
                call = lambda name=name: copy(name, st, out, None, None, rc, b, 0, 2)
                row[f"graph_ms_{name}"] = graph_ms(call, 20)
                if "stamped" in name:
                    call()
                    row[f"stamps_{name}"] = stamps(out)
            emit(**row)
    for b in NODE_COUNTS:
        words, counts = keccak.pack_ragged([rng.bytes(int(n)) for n in rng.integers(32, 533, b)])
        w = convert.words_from_numpy(words, "cuda")
        cnt = torch.as_tensor(counts, device="cuda")
        want = keccak_cuda.keccak256_blocks(w, cnt)
        extra = {}
        if "keccak_unordered" in copies:
            # each layout with and without the order by block count
            out = torch.empty_like(want)
            for lanes in k_layouts:
                rc = keccak_cuda._round_constants(w.device, lanes)
                for name in ("keccak_kernel", "keccak_unordered"):
                    call = lambda name=name: copy(name, None, out, w, cnt, rc, b, w.shape[1], lanes)
                    extra[f"graph_ms_{lanes}_{name.split('_')[1]}"] = graph_ms(call, 20)
                    extra[f"equal_{lanes}_{name.split('_')[1]}"] = bool(torch.equal(out, want))
        timed("keccak256_blocks", w.shape, lambda: keccak_cuda.keccak256_blocks(w, cnt), k_layouts,
              lambda lanes: keccak_cuda.keccak256_blocks_lanes(w, cnt, lanes), blocks=int(counts.sum()), **extra)

    def sha_case(msgs, **tags) -> None:
        words, counts = sha256.pack_ragged(msgs)
        w = convert.words_from_numpy(words, "cuda")
        cnt = torch.as_tensor(counts, device="cuda")
        extra = {}
        if "sha256_unordered" in copies and w.shape[1] > 1:
            # the thread layout with and without the order by block count
            want = sha256_cuda.sha256_compress(None, w, cnt)
            out, kh = torch.empty_like(want), sha256_cuda._constants(w.device)
            for name in ("sha256_kernel", "sha256_unordered"):
                call = lambda name=name: copy(name, None, out, w, cnt, kh, len(msgs), w.shape[1], 0)
                extra[f"graph_ms_thread_{name.split('_')[1]}"] = graph_ms(call, 20)
                extra[f"equal_thread_{name.split('_')[1]}"] = bool(torch.equal(out, want))
        timed("sha256_compress", w.shape, lambda: sha256_cuda.sha256_compress(None, w, cnt), s_layouts,
              lambda lay: sha256_cuda.sha256_compress_layout(None, w, cnt, lay), blocks=int(counts.sum()),
              **tags, **extra)

    commitments = [rng.bytes(48) for _ in range(SHA_WIDTHS[-1])]
    for b in SHA_WIDTHS:
        sha_case(commitments[:b])
    for b in SHA_WIDTHS:
        mix = [rng.bytes(int(n)) for n in rng.integers(0, 300, b)]
        sha_case(mix, mix="0-299 bytes")
        if b <= SORTED_MAX:
            sha_case(sorted(mix, key=len), mix="0-299 bytes, sorted by length")
    return 0


if __name__ == "__main__":
    sys.exit(main())
