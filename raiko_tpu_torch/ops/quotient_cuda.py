"""The quotient stage's constraint evaluation on the card: kernel Q1.

Counterpart of the XLA program the reference compiles per AIR for its
quotient (raiko_tpu/stark/prover.py ``_quotient_stage_for``: ``jax.jit``
``qfn``, or host numpy for ``eager_quotient`` AIRs); the JAX package has no
Pallas kernel for it.  The CUDA source is csrc/babybear_quotient.cu (its
header note says what bounds the kernel on the H100 and how the design
answers it).

``quotient_numerator`` walks an AIR's recorded tape
(``stark/quotient_tape.py``) over every LDE row: a thread evaluates one row
through one segment of the tape, its slots in a shared-memory tile
[slot][thread], and folds each constraint row into its kind's accumulator
with its power of alpha; each block first computes the tape's
row-invariant values from the table's publics, challenge and bus
coordinates.  With one segment that launch writes the (4, m) numerator;
with G segments it writes G partial numerators, which ``quotient_sum``
adds in a second launch.

On a CUDA tensor the wrapper launches the kernels or raises; only a CPU
tensor goes to the plain version, ``quotient_tape.quotient_numerator_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..fields import babybear as bb
from ..stark import quotient_tape as qt

CHUNK = 256  # instructions a block stages in shared memory (csrc/babybear_quotient.cu kChunk)
SMEM_BYTES = 232448  # shared memory a block can use on the H100 (227 KB)


def launch_shape(tape: qt.Tape, m: int) -> tuple[int, int, int]:
    """(threads a block, blocks a segment, dynamic shared-memory bytes) of
    Q1 on a table of `m` LDE rows: 128, 64 or 32 threads, the most whose
    slot tile fits beside the instruction chunk and the scalars; a thread
    per row."""
    fixed = 16 * CHUNK + 4 * (-(-tape.n_scalars // 4) * 4)
    slots = int(tape.seg_slots.max())
    for threads in (128, 64, 32):
        smem = fixed + 4 * threads * slots
        if smem <= SMEM_BYTES:
            return threads, -(-m // threads), smem
    raise ValueError(f"quotient_numerator: {tape.air}'s tape needs {slots} slots and {tape.n_scalars} scalars, "
                     f"more than a block's shared memory holds")


def _device_tape(tape: qt.Tape, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(program, segment offsets, uniform program, its level offsets) on
    `device`, uploaded once."""
    key = str(device)
    got = tape.device_arrays.get(key)
    if got is None:
        got = tuple(torch.as_tensor(a, device=device)
                    for a in (tape.program, tape.seg_offsets, tape.uniform, tape.uniform_levels))
        tape.device_arrays[key] = got
    return got


def quotient_numerator(tape: qt.Tape, t_lde: torch.Tensor, aux_lde, fixed_lde, next_perm: torch.Tensor,
                       publics, chal, bus, alpha_pows: torch.Tensor, sels: torch.Tensor) -> torch.Tensor:
    """The (m, 4) int32 quotient numerator sum_i alpha^i · c_i · sel_kind(i)
    of `tape` (arguments as ``quotient_tape.quotient_numerator_plain``),
    a view of its (4, m) transpose.  On the card: t_lde, aux_lde and
    fixed_lde (W, m) int32, next_perm (m,) int64, alpha_pows (rows, 4)
    int32, sels (4, m) int32, all contiguous on the current device."""
    if t_lde.device.type == "cpu":
        return qt.quotient_numerator_plain(tape, t_lde, aux_lde, fixed_lde, next_perm, publics, chal, bus,
                                           alpha_pows, sels)
    return prepare(tape, t_lde, aux_lde, fixed_lde, next_perm, publics, chal, bus, alpha_pows, sels)()


def prepare(tape: qt.Tape, t_lde: torch.Tensor, aux_lde, fixed_lde, next_perm: torch.Tensor, publics, chal, bus,
            alpha_pows: torch.Tensor, sels: torch.Tensor):
    """``quotient_numerator``'s host half on CUDA tensors: the checks, the
    scalars' upload and the output's allocation.  Returns the function that
    launches Q1 (and ``quotient_sum``) on them and returns the numerator,
    so a timer can time the launches alone."""
    m = t_lde.shape[1]
    kernels.check(t_lde, "quotient_numerator trace", torch.int32, (m,))
    for t, name, need in ((aux_lde, "aux", tape.widths["aux"]), (fixed_lde, "fixed", tape.widths["fixed"])):
        if t is not None:
            kernels.check(t, f"quotient_numerator {name}", torch.int32, (m,))
        if need and (t is None or t.shape[0] < need):
            raise ValueError(f"quotient_numerator: the tape reads {need} {name} columns, got "
                             f"{None if t is None else tuple(t.shape)}")
    if t_lde.shape[0] < tape.widths["trace"]:
        raise ValueError(f"quotient_numerator: the tape reads {tape.widths['trace']} trace columns, got "
                         f"{tuple(t_lde.shape)}")
    kernels.check(next_perm, "quotient_numerator next_perm", torch.int64, (m,))
    kernels.check(alpha_pows, "quotient_numerator alpha_pows", torch.int32, (tape.rows, 4))
    kernels.check(sels, "quotient_numerator sels", torch.int32, (len(qt.KINDS), m))
    dev = t_lde.device
    program, seg_offsets, uniform, uniform_levels = _device_tape(tape, dev)
    scalars_in = tape.scalar_inputs(publics, chal, bus)
    scalars = torch.as_tensor(scalars_in.view(np.int32), device=dev)
    g = tape.segments
    threads, blocks, smem = launch_shape(tape, m)
    partial = torch.empty((g, 4, m), dtype=torch.int32, device=dev)

    def run() -> torch.Tensor:
        kernels.launch("raiko_babybear_quotient", "quotient", program, seg_offsets, uniform, uniform_levels,
                       scalars, t_lde, aux_lde, fixed_lde, alpha_pows, next_perm, sels, partial,
                       len(tape.uniform_levels) - 1, len(scalars_in), tape.n_scalars, m, g, threads, blocks, smem)
        return (partial[0] if g == 1 else quotient_sum(partial)).T

    return run


def quotient_sum(partial: torch.Tensor) -> torch.Tensor:
    """(G, 4, m) partial numerators -> their (4, m) sum mod p, int32."""
    if partial.dim() != 3 or partial.shape[1] != 4:
        raise ValueError(f"quotient_sum: expected (G, 4, m), got {tuple(partial.shape)}")
    if partial.device.type == "cpu":
        return quotient_sum_plain(partial)
    kernels.check(partial, "quotient_sum", torch.int32, tuple(partial.shape[1:]))
    g, _, m = partial.shape
    out = torch.empty((4, m), dtype=torch.int32, device=partial.device)
    kernels.launch("raiko_babybear_quotient_sum", "quotient_sum", partial, out, g, 4 * m)
    return out


def quotient_sum_plain(partial: torch.Tensor) -> torch.Tensor:
    """``quotient_sum``'s plain version: one int64 sum (G·p < 2^63) and one
    reduction."""
    return (partial.long().sum(0) % bb.P).to(torch.int32)
