"""The quotient stage's constraint evaluation on the card: kernel Q1.

Counterpart of the XLA program the reference compiles per AIR for its
quotient (raiko_tpu/stark/prover.py ``_quotient_stage_for``: ``jax.jit``
``qfn``, or host numpy for ``eager_quotient`` AIRs); the JAX package has no
Pallas kernel for it.  The CUDA source is csrc/babybear_quotient.cu (its
header note says what bounds the kernel on the H100 and how the design
answers it).

``quotient_numerator`` runs an AIR's recorded tape (``stark/quotient_tape.py``)
over every LDE row in up to three launches:

* ``quotient_uniform``: the tape's row-invariant values, from the table's
  publics, challenge and bus coordinates, once per call (one warp, a step
  of 32 independent values at a time), where the tape has any;
* ``quotient``: a group of L lanes walks each LDE row through one of the
  tape's G segments, a step of L independent instructions at a time, with
  the segment's columns, alpha powers, scalars and value slots in shared
  memory and its instructions streamed in by TMA (``launch_shape`` sizes
  the blocks); with one segment it writes the (4, m) numerator, with G
  segments G partial numerators,
* ``quotient_sum``: the G partials added, where G > 1.

On a CUDA tensor the wrappers launch the kernels or raise; only a CPU
tensor goes to the plain versions, ``quotient_tape.quotient_numerator_plain``
and ``Tape.scalars``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..fields import babybear as bb
from ..stark import quotient_tape as qt

# the most consumer threads a block (L lanes x rows), beside the producer
# warp: on an H100 (700 W; tools/time_quotient.py --block-lanes) Q1 took
# 0.21 / 0.22 / 0.29 ms on the EVM CPU table and 0.59 / 0.58-0.63 / 0.64
# ms on the keccak chunk at 256 / 128 / 64
BLOCK_LANES = 256
UNIFORM_CHUNK = 2048  # uniform instructions a buffer of quotient_uniform (kUniChunk); it keeps two


def launch_shape(tape: qt.Tape, m: int) -> tuple[int, int, int, int]:
    """(lanes L, rows a block R, blocks a segment, dynamic shared-memory
    bytes) of Q1 on a table of `m` LDE rows: R the most rows, a power of
    two of at least one warp's (32 / L) and at most BLOCK_LANES / L and the
    rows of the table, whose tile fits a block's shared memory; a block
    takes R * L + 32 threads (the last warp streams the tape).  Worked out
    once for each tape and m."""
    key = ("launch_shape", m, BLOCK_LANES)
    got = tape.device_arrays.get(key)
    if got is not None:
        return got
    lanes = tape.lanes
    rows = qt.warp_rows(lanes)
    if tape.smem_bytes(rows) > qt.SMEM_BYTES:
        raise ValueError(f"quotient_numerator: {tape.air}'s tape needs {tape.smem_bytes(rows)} bytes of shared "
                         f"memory for one warp's rows ({tape.stats['max_columns']} columns, "
                         f"{tape.stats['max_slots']} slots, {tape.n_scalars} scalars), more than a block holds")
    while 2 * rows * lanes <= BLOCK_LANES and rows < m and tape.smem_bytes(2 * rows) <= qt.SMEM_BYTES:
        rows *= 2
    got = tape.device_arrays[key] = (lanes, rows, -(-m // rows), tape.smem_bytes(rows))
    return got


def uniform_smem(tape: qt.Tape) -> int:
    """``quotient_uniform``'s dynamic shared memory: two instruction
    chunks, the scalars."""
    smem = 2 * 16 * UNIFORM_CHUNK + 4 * tape.n_scalars
    if smem > qt.SMEM_BYTES:
        raise ValueError(f"quotient_uniform: {tape.air}'s {tape.n_scalars} scalars do not fit a block")
    return smem


def _device_tape(tape: qt.Tape, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(program, segment offsets, slots, column lists, their offsets, row
    ranges, uniform program) on `device`, uploaded once."""
    key = str(device)
    got = tape.device_arrays.get(key)
    if got is None:
        got = tuple(torch.as_tensor(a, device=device)
                    for a in (tape.program, tape.seg_offsets, tape.seg_slots, tape.seg_cols, tape.seg_col_offsets,
                              tape.seg_rows, tape.uniform))
        tape.device_arrays[key] = got
    return got


def _scalar_inputs(tape: qt.Tape, publics, chal, bus, device: torch.device) -> torch.Tensor:
    """(n_scalars,) int32 on `device`: ``Tape.scalar_inputs``, then room
    for the uniform values."""
    host = np.zeros(tape.n_scalars, dtype=np.uint32)
    inputs = tape.scalar_inputs(publics, chal, bus)
    host[:len(inputs)] = inputs
    return torch.as_tensor(host.view(np.int32), device=device)


def _launch_uniform(tape: qt.Tape, arrays: tuple, scalars: torch.Tensor, smem: int) -> None:
    """``quotient_uniform`` into `scalars`, where the tape has uniform
    values."""
    if not len(tape.uniform):
        return
    kernels.launch("raiko_babybear_quotient_uniform", "quotient_uniform", arrays[6], scalars, len(tape.uniform),
                   tape.n_scalars, smem)


def prepare_uniform(tape: qt.Tape, publics, chal, bus, device):
    """(scalars, run): the (n_scalars,) int32 scalars of one call on a CUDA
    `device`, the inputs uploaded, and the function that launches
    ``quotient_uniform`` into them (again and again: the inputs stay)."""
    device = torch.device(device)
    scalars = _scalar_inputs(tape, publics, chal, bus, device)
    arrays = _device_tape(tape, device)
    smem = uniform_smem(tape)
    return scalars, lambda: _launch_uniform(tape, arrays, scalars, smem)


def uniform_scalars(tape: qt.Tape, publics, chal, bus, device) -> torch.Tensor:
    """Every scalar operand of one call, (n_scalars,) int32 Montgomery:
    the inputs, then the uniform values, by ``quotient_uniform`` on a CUDA
    device (its plain version, ``Tape.scalars``, on the CPU)."""
    if torch.device(device).type == "cpu":
        return torch.as_tensor(tape.scalars(publics, chal, bus).view(np.int32))
    scalars, run = prepare_uniform(tape, publics, chal, bus, device)
    run()
    return scalars


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
    launches Q1 (``quotient_uniform``, ``quotient`` and, for G > 1,
    ``quotient_sum``) on them and returns the numerator, so a timer can
    time the launches alone."""
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
    arrays = _device_tape(tape, dev)
    scalars, uniform = prepare_uniform(tape, publics, chal, bus, dev)
    g = tape.segments
    lanes, rows, blocks, smem = launch_shape(tape, m)
    partial = torch.empty((g, 4, m), dtype=torch.int32, device=dev)

    def run() -> torch.Tensor:
        uniform()
        kernels.launch("raiko_babybear_quotient", "quotient", *arrays[:6], scalars, t_lde, aux_lde, fixed_lde,
                       alpha_pows, next_perm, sels, partial, tape.n_scalars, m, g, lanes, rows.bit_length() - 1,
                       blocks, smem)
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
