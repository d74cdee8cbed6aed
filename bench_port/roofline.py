"""The least time the commitment kernels' work could take on the card.

Each launch's work is counted from its shapes, for the algorithm, not for
the kernel that runs it: each input element read once and each output
written once, and the 32-bit integer multiplies of the transform or the
permutations.  Copied from ``chip_smoke.py``'s work functions
(``_ntt_work``, its ``ntt_coset``, ``hash_work`` and tree counts), less
the term of the four-step NTT's cross twiddles, which counts how B5 is
built rather than the transform.

Rates: device memory at NVIDIA's published 3.35 TB/s (H100 SXM data
sheet); 32-bit integer multiplies at 64 per SM per clock (compute
capability 9.0, CUDA C++ Programming Guide, arithmetic throughput table)
times the card's SMs and its maximum SM clock.  The integer rate is
derived, not published: 132 SMs x 64 x 1,980 MHz = 16.7 T/s on an H100
SXM.  The least time is the larger of the bytes over the memory rate and
the multiplies over the integer rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_SM_PER_CLOCK = 64
BB_MUL = 4  # BabyBear Montgomery product: lo, hi, m, umulhi(m, p)
# Poseidon2 (width 16, 8 external and 13 internal rounds): 772 products
PERM_MULS = BB_MUL * ((8 * 16 * 4) + 13 * (4 + 16))
RATE, OUT = 8, 8  # the row sponge's rate and digest words
KERNELS = ("intt", "ntt_coset", "poseidon2_hash_rows", "poseidon2_merkle")


def _log2(n: int) -> int:
    return n.bit_length() - 1


def intt_work(bsz: int, n: int) -> tuple[float, float]:
    """(bytes, multiplies) of an inverse NTT of (bsz, n): n/2 log n
    butterflies and the 1/n scale a row."""
    return 8.0 * bsz * n, BB_MUL * (bsz * (n // 2) * _log2(n) + bsz * n)


def ntt_coset_work(bsz: int, n: int, blowup_log: int) -> tuple[float, float]:
    """(bytes, multiplies) of the LDE of (bsz, n) coefficients onto a coset
    of n·2^blowup_log points: the coset scaling (n products) and the
    forward transform's butterflies a row."""
    big = n << blowup_log
    return 4.0 * bsz * (n + big), BB_MUL * bsz * (n + (big // 2) * _log2(big))


def hash_rows_work(bsz: int, width: int) -> tuple[float, float]:
    """(bytes, multiplies) of the sponge over (bsz, width) rows: a
    permutation per RATE words a row."""
    return 4.0 * (bsz * width + bsz * OUT), float(bsz * max(1, -(-width // RATE)) * PERM_MULS)


def merkle_work(leaves: int) -> tuple[float, float]:
    """(bytes, multiplies) of the tree over `leaves` digests: leaves - 1
    compressions, the leaves read and every internal node written once."""
    return 4.0 * OUT * (2 * leaves - 1), float((leaves - 1) * PERM_MULS)


def least_s(nbytes: float, mults: float, imad_per_s: float) -> float:
    """The least seconds of a launch: its bytes or its multiplies, whichever
    bounds it."""
    return max(nbytes / HBM_BYTES_PER_S, mults / imad_per_s)


def work(name: str, shape: tuple) -> tuple[float, float]:
    """(bytes, multiplies) of one launch of kernel `name` at `shape` (the
    wrapper's arguments, as ``run.py`` records them)."""
    if name == "intt":
        return intt_work(*shape)
    if name == "ntt_coset":
        return ntt_coset_work(*shape)
    if name == "poseidon2_hash_rows":
        return hash_rows_work(*shape)
    if name == "poseidon2_merkle":
        return merkle_work(*shape)
    raise KeyError(name)


def share(run, kernels: tuple) -> float | None:
    """Percent of the roofline that the calls of `kernels` in a traced
    window reach: their least time summed over their device time summed;
    None when the window has no such call."""
    if run.trace is None:
        return None
    calls = [(kernel, shape, seconds) for kernel, shape, seconds in run.trace.kernel_calls() if kernel in kernels]
    spent = sum(seconds for *_, seconds in calls)
    if spent <= 0:
        return None
    imad_per_s = run.card["sms"] * IMAD_PER_SM_PER_CLOCK * run.card["max_sm_mhz"] * 1e6
    return 100.0 * sum(least_s(*work(kernel, shape), imad_per_s) for kernel, shape, _ in calls) / spent
