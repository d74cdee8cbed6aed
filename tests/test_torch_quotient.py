"""The quotient stage's recorded constraint tapes (``stark/quotient_tape.py``)
and kernel Q1 (``ops/quotient_cuda.py``), on the CPU against the op-by-op
evaluation and the JAX package; all comparisons bit for bit (tolerance 0:
the field arithmetic is exact).

* Every AIR class under ``stark/airs/`` records to a tape whose constraint
  rows, counts and kinds are the AIR's and whose operands lie inside its
  widths, its segments' slots and column lists; the instance-parameterised
  EVM classes are recorded from the fixtures of ``tests/test_torch_evm.py``
  (those of ``tests/test_evm_air.py`` and ``tests/test_evm_call.py``), the
  outer circuit's from the circuit bundle of ``tests/test_torch_seal.py``.
* Every class's tape, scheduled at L = 1, 4 and 32 lanes a row, keeps the
  step schedule's invariants: a step reads only slots that earlier steps
  wrote, writes no slot twice and none that it reads, keeps within the
  slot and column caps, and each segment's column list covers what it
  reads.
* The tape's plain version equals the op-by-op numerator
  (``testing.quotient.numerator_op_by_op``) on every table of the golden call tree,
  the keccak-chunk AIR at a small n, fib, the transcript AIR, the outer
  circuit's ``CircuitAir`` and ``Poseidon2CallsAir``, each table's trace
  with seeded challenges and alpha (``testing/quotient.py``); walked with
  each step's instructions in reverse order too, on the call tree's
  tables, fib and the transcript.
* The quotient chunks through the tape equal those of the JAX package's
  ``_quotient_stage_for``: for the EVM CPU table (an ``eager_quotient``
  AIR, the reference's host-numpy route) and for fib (its jitted route).
* Instances that share the reference's stage key but hold other instance
  data record equal tapes.
* The call tree's proof with every table's numerator from the tape's plain
  version equals ``tests/golden/stark_evm_call_tree.json``.

The ``cuda`` tests hold Q1 equal to the plain version on the same tables
on a card, and on the EVM CPU table and the keccak chunk at forced lanes
and segments.
"""

import hashlib
import inspect
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_evm as tte
import test_torch_seal as tts
from raiko_tpu.fields import babybear as jbb
from raiko_tpu.fields import babybear_ext as jef
from raiko_tpu.stark import prover as jprover
from raiko_tpu.stark.airs import evm_air as jea
from raiko_tpu.stark.airs.fib import FibAir as JFibAir
from raiko_tpu.stark.domain import Domain as JDomain
from raiko_tpu_torch import convert
from raiko_tpu_torch.fields import babybear as bb
from raiko_tpu_torch.fields import babybear_ext as ef
from raiko_tpu_torch.ops import poseidon2 as p2
from raiko_tpu_torch.stark import circuit, prover, quotient_tape as qt, verifier
from raiko_tpu_torch.stark.air import Air, ConstraintBuilder, Probe
from raiko_tpu_torch.stark.airs import bus, containment, evm_air as ea, evm_call as ec, keccak_air as ka
from raiko_tpu_torch.stark.airs import circuit_air, fib, lookup, permcheck, poseidon2_air, poseidon2_calls
from raiko_tpu_torch.testing.goldens import call_tree_tables, golden_air
from raiko_tpu_torch.testing.quotient import numerator_case

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
AIRS_DIR = os.path.join(os.path.dirname(os.path.abspath(prover.__file__)), "airs")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _golden(case: str) -> dict:
    with open(os.path.join(GOLDEN, f"stark_{case}.json")) as f:
        return json.load(f)


# --- the AIRs: every class, and the tables the numerators compare on

# the EVM fixtures whose tables hold every EVM class
EVM_CASES = ("tree", "frame", "call_variants", "account_state")
OTHER_CLASSES = {
    "BusTableAir": lambda: bus.BusTableAir(1),
    "ByteCodeAir": lambda: containment.ByteCodeAir([containment.RATE_BYTES]),
    "ContainAir": lambda: containment.ContainAir(1),
    "FibAir": lambda: fib.FibAir(),
    "KeccakFAir": lambda: ka.KeccakFAir([0] * 25),
    "KeccakSpongeAir": lambda: ka.KeccakSpongeAir(b"abc"),
    "KeccakSpongeV2Air": lambda: ka.KeccakSpongeV2Air([1, 2]),
    "KeccakBatchSpongeAir": lambda: ka.KeccakBatchSpongeAir([b"abc", b"hello world"]),
    "LookupAir": lambda: lookup.LookupAir(),
    "PermutationAir": lambda: permcheck.PermutationAir(),
    "Poseidon2TranscriptAir": lambda: golden_air("transcript", _golden("transcript")["inputs"])[0],
    "CircuitAir": lambda: _outer()[0][0],
    "Poseidon2CallsAir": lambda: _outer()[1][0],
}
EVM_CLASSES = ("EvmCpuAir", "EvmProgramAir", "EvmStackAir", "EvmCalldataAir", "MemRamAir", "EvmStorageAir",
               "EvmKeccakCallAir", "EvmSpongeAir", "ArithAir", "EvmCopyAir", "CodeCopyAir", "EvmLogAir",
               "MemSpanBridgeAir", "EvmAddrAir", "PrecompileCallAir", "EvmBalanceAir", "AcctCtxAir")

_CACHE: dict = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _evm_tables(case: str) -> list:
    return _cached(("evm", case), lambda: tte._tables(ea, ec, tte._execute(ea, case))[1])


def _outer():
    """(CircuitAir, gate trace), (Poseidon2CallsAir, call trace) of the
    small circuit of tests/test_torch_seal.py's builder."""

    def build():
        bundle = tts._build(circuit.CircuitBuilder, circuit.FreeLane, ef.H_ONE, p2.host_permute, True)
        return ((circuit_air.CircuitAir(bundle.gate_fixed), bundle.gate_trace),
                (poseidon2_calls.Poseidon2CallsAir(bundle.call_fixed), bundle.call_trace))

    return _cached("outer", build)


def _instance(name: str) -> Air:
    if name in OTHER_CLASSES:
        return _cached(("air", name), OTHER_CLASSES[name])
    for case in EVM_CASES:
        found = [air for air, trace, _ in _evm_tables(case) if type(air).__name__ == name]
        if found:
            return found[0]
    raise LookupError(name)


def test_the_classes_are_every_air_under_airs():
    found = set()
    for mod in (bus, containment, ea, ec, ka, fib, lookup, permcheck, poseidon2_air, poseidon2_calls, circuit_air,
                __import__("raiko_tpu_torch.stark.airs.evm_arith", fromlist=["x"]),
                __import__("raiko_tpu_torch.stark.airs.evm_copy", fromlist=["x"]),
                __import__("raiko_tpu_torch.stark.airs.evm_keccak", fromlist=["x"]),
                __import__("raiko_tpu_torch.stark.airs.evm_storage", fromlist=["x"])):
        found.update(n for n, c in inspect.getmembers(mod, inspect.isclass)
                     if issubclass(c, Air) and c is not Air and c.__module__ == mod.__name__)
    modules = {f[:-3] for f in os.listdir(AIRS_DIR) if f.endswith(".py") and f != "__init__.py"}
    assert modules == {"bus", "containment", "evm_air", "evm_call", "keccak_air", "fib", "lookup", "permcheck",
                       "poseidon2_air", "poseidon2_calls", "circuit_air", "evm_arith", "evm_copy", "evm_keccak",
                       "evm_storage"}
    assert found == set(OTHER_CLASSES) | set(EVM_CLASSES)


def _graph(name: str) -> qt.Graph:
    """The class's recorded graph, once per module (the EVM CPU table's
    takes a second)."""
    return _cached(("graph", name), lambda: qt.record_graph(_instance(name)))


ALL_CLASSES = sorted(set(OTHER_CLASSES) | set(EVM_CLASSES))


@pytest.mark.parametrize("name", ALL_CLASSES)
def test_every_air_class_records(name):
    air = _instance(name)
    tape = _cached(("tape", name), lambda: qt.tape_of(_graph(name), 256))
    probe = ConstraintBuilder(Probe())
    air.eval(probe)
    assert tape.counts == [c.count for c in probe.constraints]
    assert tape.kinds == [c.kind for c in probe.constraints]
    assert tape.rows == sum(tape.counts) == air.num_constraints()
    assert tape.row_kinds.tolist() == [qt.KINDS.index(k) for k, c in zip(tape.kinds, tape.counts) for _ in range(c)]
    prog = tape.program.view(np.uint32)
    # every constraint row is folded once, by its own kind, in its segment
    acc = prog[(prog[:, 0] >= qt.ACC) & (prog[:, 0] < qt.NOP)]
    assert sorted(acc[:, 1].tolist()) == list(range(tape.rows))
    assert (acc[:, 0] - qt.ACC == tape.row_kinds[acc[:, 1]]).all()
    assert tape.seg_rows[0] == 0 and tape.seg_rows[-1] == tape.rows and (np.diff(tape.seg_rows) > 0).all()
    # operands lie inside each segment's slots and column list and the
    # scalars; the column lists inside the AIR's widths
    limits = {qt.LOCAL: air.width, qt.NEXT: air.width, qt.AUX: air.aux_width, qt.AUX_NEXT: air.aux_width}
    for g in range(tape.segments):
        steps, cols = tape.segment(g)
        seg = steps.reshape(-1, 4)
        ops = seg[:, 0]
        folds = seg[(ops >= qt.ACC) & (ops < qt.NOP)]
        assert ((folds[:, 1] >= tape.seg_rows[g]) & (folds[:, 1] < tape.seg_rows[g + 1])).all()
        arith = seg[ops < qt.ACC]
        # a slot is a place of the row's tile after the segment's columns
        tile = len(cols) + tape.seg_slots[g]
        assert ((arith[:, 1] >= len(cols)) & (arith[:, 1] < tile)).all()
        refs = np.concatenate([seg[ops < qt.NOP, 2], arith[:, 3]])
        kinds, idx = refs >> qt.KIND_SHIFT, refs & qt.INDEX_MASK
        assert set(np.unique(kinds).tolist()) <= {qt.SLOT, qt.COLUMN, qt.SCALAR}
        assert (idx[kinds == qt.SLOT] >= len(cols)).all()
        for kind, limit in ((qt.SLOT, tile), (qt.COLUMN, len(cols)), (qt.SCALAR, tape.n_scalars)):
            assert (idx[kinds == kind] < limit).all(), (g, kind)
        for kind, limit in limits.items():
            assert ((cols & qt.INDEX_MASK)[cols >> qt.KIND_SHIFT == kind] < limit).all(), (g, kind)
        assert set(np.unique(cols >> qt.KIND_SHIFT).tolist()) <= set(range(qt.LOCAL, qt.FIXED + 1))


@pytest.mark.parametrize("lanes", [1, 4, 32])
@pytest.mark.parametrize("name", ALL_CLASSES)
def test_scheduled_tape_invariants(name, lanes):
    """The step schedule at L lanes (more where one constraint row's
    columns fit no warp's rows at L): each step's instructions are
    independent, so the kernel's lanes may run them in any order."""
    tape = qt.tape_of(_graph(name), 256, lanes=lanes)
    assert tape.lanes >= lanes and tape.fits()
    lanes = tape.lanes
    assert (tape.seg_offsets % lanes == 0).all()
    assert tape.stats["max_slots"] <= qt.MAX_SEGMENT_SLOTS and tape.stats["max_columns"] <= qt.MAX_SEGMENT_COLUMNS
    for g in range(tape.segments):
        steps, cols = tape.segment(g)
        n_steps = len(steps)
        step = np.repeat(np.arange(n_steps), lanes)
        seg = steps.reshape(-1, 4)
        ops = seg[:, 0]
        live = ops < qt.NOP
        writes = ops < qt.ACC
        # reads: (step, slot) of every slot operand
        reads = [(step[live], seg[live, 2]), (step[writes], seg[writes, 3])]
        r_step = np.concatenate([t[(w >> qt.KIND_SHIFT) == qt.SLOT] for t, w in reads])
        r_slot = np.concatenate([(w & qt.INDEX_MASK)[(w >> qt.KIND_SHIFT) == qt.SLOT] for _, w in reads])
        w_step, w_slot = step[writes], seg[writes, 1].astype(np.int64)
        slots = len(cols) + int(tape.seg_slots[g])  # the places of a row's tile
        # every step reads only slots that an earlier step wrote
        first = np.full(slots, n_steps)
        np.minimum.at(first, w_slot, w_step)
        assert (first[r_slot] < r_step).all(), g
        # no slot is written twice in a step, nor read and written in one
        w_key = w_step * slots + w_slot
        assert len(np.unique(w_key)) == len(w_key), g
        assert not np.intersect1d(w_key, r_step * slots + r_slot).size, g
        # the column list covers every column operand, and each entry is read
        col_refs = np.concatenate([w[(w >> qt.KIND_SHIFT) == qt.COLUMN] & qt.INDEX_MASK for _, w in reads])
        assert np.array_equal(np.unique(col_refs), np.arange(len(cols))), g
        assert len(np.unique(cols)) == len(cols)


def test_recorder_refuses_what_it_cannot_take():
    class Odd(Air):
        width = 2

        def eval(self, b):
            b.all_rows(b.alg.transpose(b.local(0)))

    with pytest.raises(qt.TapeError, match="Odd.*transpose"):
        qt.record(Odd(), 16)

    class Sums(Air):
        width = 4

        def eval(self, b):
            blk = b.local_block(range(4))
            b.all_rows_block(blk + blk, 8)

    with pytest.raises(qt.TapeError):
        qt.record(Sums(), 16)


# --- the plain version against the op-by-op numerator


def _numerator_tables() -> dict:
    def build():
        tables = {f"call_tree_{i}": t for i, t in enumerate(call_tree_tables(_golden("evm_call_tree")["inputs"]))}
        kair = ka.KeccakBatchSpongeAir([bytes(range(40)), b"quotient tape" * 13])
        tables["keccak_chunk_small"] = (kair, kair.trace(), kair.publics())
        tables["fib"] = golden_air("fib", _golden("fib")["inputs"])
        tables["transcript"] = golden_air("transcript", _golden("transcript")["inputs"])
        (cair, gate), (pair, call) = _outer()
        tables["circuit_air"] = (cair, gate, [])
        tables["poseidon2_calls"] = (pair, call, [])
        return tables

    return _cached("numerator_tables", build)


NUMERATOR_TABLES = [f"call_tree_{i}" for i in range(17)] + [
    "keccak_chunk_small", "fib", "transcript", "circuit_air", "poseidon2_calls"]


def _case_and_op_by_op(table: str):
    """The table's CPU case and its op-by-op numerator, once per module."""

    def build():
        air, trace, publics = _numerator_tables()[table]
        case = numerator_case(air, trace, publics, "cpu", seed=7)
        return case, case.op_by_op()

    return _cached(("op_by_op", table), build)


@pytest.mark.parametrize("table", NUMERATOR_TABLES)
def test_plain_equals_op_by_op(table):
    case, want = _case_and_op_by_op(table)
    got = case.plain()
    assert got.shape == (case.dom.m, 4) and got.dtype == torch.int32
    assert torch.equal(got.long(), want.long())


@pytest.mark.parametrize("table", [f"call_tree_{i}" for i in range(17)] + ["fib", "transcript"])
def test_plain_reversed_steps_equals_op_by_op(table):
    """Each step's instructions walked in reverse order give the same
    numerator: a step reads nothing that it writes or overwrites."""
    case, want = _case_and_op_by_op(table)
    assert torch.equal(case.plain(reverse_steps=True).long(), want.long())


def test_call_tree_has_seventeen_tables():
    assert len(call_tree_tables(_golden("evm_call_tree")["inputs"])) == 17


def test_quotient_sum_plain():
    rng = np.random.default_rng(3)
    from raiko_tpu_torch.ops import quotient_cuda

    partial = torch.as_tensor(rng.integers(0, bb.P, (5, 4, 33)), dtype=torch.int32)
    want = np.asarray(partial.numpy().astype(object).sum(0) % bb.P, dtype=np.int64)
    assert quotient_cuda.quotient_sum(partial).long().numpy().tolist() == want.tolist()


# --- the chunks against the JAX package's quotient stage


def _jax_chunks(jair, case, fixed) -> np.ndarray:
    """Chunks of jprover._quotient_stage_for on the case's inputs."""
    mont = lambda vals: jnp.asarray(np.array([(x % bb.P) * bb.R % bb.P for x in vals], dtype=np.uint32))  # noqa: E731
    jdom = JDomain(case.dom.log_n, jprover.BLOWUP_LOG)
    fixed_m = jbb.to_mont(jnp.asarray(np.ascontiguousarray(fixed))) if fixed is not None else None
    apows, apow = [], jef.H_ONE
    for count in jprover._constraint_counts(jair):
        pows = []
        for _ in range(count):
            pows.append(apow)
            apow = jef.h_mul(apow, case.alpha)
        apows.append(jef.to_device(pows))
    lde = lambda t: jnp.asarray(t.numpy().astype(np.uint32)) if t is not None else None  # noqa: E731
    qfn = jprover._quotient_stage_for(jair, jdom, fixed_m is not None)
    chunks, _, _ = qfn(lde(case.t_lde), lde(case.aux_lde), mont(case.chal) if case.chal else None,
                       mont(case.bus) if case.bus else None, fixed_m, apows,
                       jnp.asarray(jprover._sinv_pows(jdom.shift, jdom.m)), mont(case.publics))
    return np.asarray(chunks)


def _port_chunks(case, fixed) -> np.ndarray:
    fixed_m = bb.to_mont(convert.words_from_numpy(np.ascontiguousarray(fixed), "cpu")) if fixed is not None else None
    sinvp = torch.as_tensor(prover._sinv_pows(case.dom.shift, case.dom.m).astype(np.int32))
    chunks, _, _ = prover._quotient_stage(case.air, case.dom, case.t_lde, case.aux_lde, fixed_m, case.publics,
                                          case.chal, case.bus, case.alpha, sinvp)
    return convert.bb_to_numpy(chunks)


def test_chunks_equal_jax_eager_evm_cpu():
    """EvmCpuAir has eager_quotient: the reference evaluates it in host numpy."""
    inp = _golden("evm_call_tree")["inputs"]
    air, trace, publics = _numerator_tables()["call_tree_0"]
    jroot = jea.execute_frame(bytes.fromhex(inp["caller"]), jea.FrameEnv(**inp["env"]), inp["gas"],
                              world={inp["callee_address"]: {"code": bytes.fromhex(inp["callee"])}},
                              warm_addresses=set())
    jair = jea.frame_tables(jea.flatten_call_tree(jroot)[0])[0][0]
    assert type(jair).__name__ == "EvmCpuAir" and jair.eager_quotient
    case = numerator_case(air, trace, publics, "cpu", seed=11)
    want = _jax_chunks(jair, case, None)
    assert np.array_equal(_port_chunks(case, None), want)


def test_chunks_equal_jax_jitted_fib():
    air, trace, publics = _numerator_tables()["fib"]
    case = numerator_case(air, trace, publics, "cpu", seed=13)
    want = _jax_chunks(JFibAir(), case, None)
    assert np.array_equal(_port_chunks(case, None), want)


# --- instances sharing a stage key

SHARED_KEY_CLASSES = ("EvmCpuAir", "EvmProgramAir", "EvmStackAir", "EvmCalldataAir", "MemRamAir",
                      "MemSpanBridgeAir", "EvmAddrAir", "EvmBalanceAir", "EvmStorageAir")


@pytest.mark.parametrize("name", SHARED_KEY_CLASSES)
def test_shared_stage_key_records_equal_tapes(name):
    """Two instances with one stage key (the reference's cache key) but
    other instance data (code, publics, trace) record the same tape."""
    by_key: dict = {}
    for case in tte.CASES:
        for air, trace, publics in _evm_tables(case):
            if type(air).__name__ == name:
                n = trace.shape[0]
                key = qt.stage_key(air, n.bit_length() - 1, air.fixed_columns(n) is not None)
                by_key.setdefault(key, []).append((air, trace, publics))
    pairs = [v for v in by_key.values() if len(v) >= 2]
    assert pairs, f"no two {name} instances share a stage key"
    (a, ta, pa), (b, tb, pb) = pairs[0][:2]
    assert a is not b and (not np.array_equal(ta, tb) or list(pa) != list(pb))
    m = 4 * ta.shape[0]
    x, y = qt.record(a, m), qt.record(b, m)
    for field in ("program", "seg_offsets", "seg_slots", "seg_cols", "seg_col_offsets", "seg_rows", "consts",
                  "row_kinds", "uniform"):
        assert np.array_equal(getattr(x, field), getattr(y, field)), field
    assert (x.inputs, x.counts, x.kinds, x.widths) == (y.inputs, y.counts, y.kinds, y.widths)


def test_transcript_and_its_shard_take_their_own_tapes():
    """A transcript AIR and a shard of one (its whole final state exposed,
    as tpu_shard proves it) at one size record different graphs, so their
    stage keys differ (the reference's key does not tell them apart); two
    shards of other data share a key and a tape; proven one after the
    other in one process through the tape, each proof verifies."""
    rng = np.random.default_rng(3)

    def blocks():
        return [[int(v) for v in rng.integers(0, bb.P, poseidon2_air.RATE)] for _ in range(2)]

    plain = poseidon2_air.Poseidon2TranscriptAir(blocks())
    shards = [poseidon2_air.Poseidon2TranscriptAir(blocks(), initial_state=[int(v) for v in rng.integers(0, bb.P, 16)],
                                                   expose_full_state=True) for _ in range(2)]
    keys = [qt.stage_key(a, 6, True) for a in (plain, *shards)]
    assert keys[0] != keys[1] == keys[2]
    x, y, z = (qt.record(a, 256) for a in (plain, *shards))
    assert x.rows != y.rows
    assert np.array_equal(y.program, z.program) and y.inputs == z.inputs
    for air in (plain, shards[0]):
        publics = air.publics_for(air.compute_final_state() if air.expose_full_state else air.compute_digest())
        proof = prover.prove(air, air.trace(), publics, "cpu")
        assert verifier.verify(air, proof, "cpu")


def test_tape_cache_is_keyed_by_stage():
    air = fib.FibAir()
    assert qt.tape_for(air, 6, 256, False) is qt.tape_for(fib.FibAir(), 6, 256, False)
    assert qt.tape_for(air, 7, 512, False) is not qt.tape_for(air, 6, 256, False)
    # one graph for both sizes: only the segments depend on log_n
    assert [k for k in qt._GRAPHS if k[0] is fib.FibAir and not k[-1]] == [qt.stage_key(air, 6, False)[:4] + (
        air.quotient_chunks, False)]


def test_cached_tape_is_not_blocked_by_a_recording():
    """While one AIR's graph is being recorded, a tape already cached, and
    a tape of another key, are returned without waiting for it."""
    import threading

    started, release = threading.Event(), threading.Event()

    class Slow(Air):
        width = 1

        def eval(self, b):
            started.set()
            assert release.wait(30)
            b.all_rows(b.local(0))

    cached = qt.tape_for(fib.FibAir(), 6, 256, False)
    worker = threading.Thread(target=lambda: qt.tape_for(Slow(), 4, 64, False))
    worker.start()
    try:
        assert started.wait(30)
        assert qt.tape_for(fib.FibAir(), 6, 256, False) is cached
        assert qt.tape_for(fib.FibAir(), 5, 128, False).rows == cached.rows
    finally:
        release.set()
        worker.join(30)
    assert qt.tape_for(Slow(), 4, 64, False).rows == 1


def test_stats_count_each_distinct_node_once():
    """``arith_distinct`` counts each per-row node once; a product of two
    columns that two constraint rows read is computed in each of them
    (``arith_one_segment``) but is one node of the work."""

    class Shared(Air):
        width = 3

        def eval(self, b):
            xy = b.mul(b.local(0), b.local(1))
            b.all_rows(b.sub(xy, b.local(2)))
            b.all_rows(b.mul(xy, b.local(0)))

    st = qt.record(Shared(), 64).stats
    assert (st["arith_distinct"], st["mul_distinct"]) == (3, 2)
    assert (st["arith_one_segment"], st["mul_one_segment"]) == (4, 3)


# --- a whole proof through the tape's plain version


def test_call_tree_proof_through_tape_equals_golden(monkeypatch):
    g = _golden("evm_call_tree")
    inp = g["inputs"]
    root = ea.execute_frame(bytes.fromhex(inp["caller"]), ea.FrameEnv(**inp["env"]), inp["gas"],
                            world={inp["callee_address"]: {"code": bytes.fromhex(inp["callee"])}},
                            warm_addresses=set())
    calls = []
    plain = qt.quotient_numerator_plain

    def counted(*args):
        calls.append(type(args[0]).__name__)
        return plain(*args)

    monkeypatch.setattr(qt, "quotient_numerator_plain", counted)
    payload = ea.prove_call_tree(root, "cpu")
    assert len(calls) == len(payload["starks"]) == 17
    assert hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest() == g["sha256"]


# --- Q1 on a card


def _q1_launches(tape: qt.Tape) -> dict:
    """The launches of one Q1 call on `tape`."""
    want = {"quotient": 1, "quotient_sum": int(tape.segments > 1), "quotient_uniform": int(len(tape.uniform) > 0)}
    return {k: v for k, v in want.items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("table", NUMERATOR_TABLES)
def test_cuda_q1_equals_plain(cuda_device, table):
    from raiko_tpu_torch import kernels
    from raiko_tpu_torch.ops import quotient_cuda

    air, trace, publics = _numerator_tables()[table]
    case = numerator_case(air, trace, publics, cuda_device, seed=7)
    tape = case.tape()
    kernels.LAUNCHES.reset()
    got = case.kernel()
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES.snapshot()
    assert launches == _q1_launches(tape)
    assert torch.equal(got.cpu(), case.plain().cpu())
    scalars = quotient_cuda.uniform_scalars(tape, case.publics, case.chal, case.bus, cuda_device)
    assert torch.equal(scalars.cpu(), quotient_cuda.uniform_scalars(tape, case.publics, case.chal, case.bus, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [4, 16])
@pytest.mark.parametrize("lanes", [1, 4, 32])
@pytest.mark.parametrize("table", ["evm_cpu", "keccak_chunk"])
def test_cuda_q1_forced_layouts(cuda_device, table, lanes, segments):
    """Q1 on the EVM CPU table and the keccak chunk (1,024 x 4,160) with
    the lanes and the segments forced: every layout gives the plain
    version's numerator."""
    if table == "evm_cpu":
        air, trace, publics = _numerator_tables()["call_tree_0"]
    else:
        air, trace, publics = golden_air("keccak_chunk", _golden("keccak_chunk")["inputs"])[:3]
    case = numerator_case(air, trace, publics, cuda_device, seed=7)
    tape = qt.record(air, case.dom.m, segments=segments, lanes=lanes)
    assert tape.lanes == lanes and tape.fits()
    assert torch.equal(case.kernel(tape).cpu(), case.plain(tape).cpu())


# --- the launch's shape and the recorder's limits


def test_launch_shape_fits_shared_memory():
    from raiko_tpu_torch.ops import quotient_cuda

    air, trace, publics = _numerator_tables()["call_tree_0"]
    m = 4 * trace.shape[0]
    tape = qt.tape_for(air, trace.shape[0].bit_length() - 1, m, False)
    # 128 LDE rows: a warp a row, 8 rows a block
    assert m == 128 and tape.lanes == qt.lanes_for(m) == 32
    lanes, rows, blocks, smem = quotient_cuda.launch_shape(tape, m)
    assert (lanes, rows, blocks) == (32, quotient_cuda.BLOCK_LANES // 32, m * 32 // quotient_cuda.BLOCK_LANES)
    assert smem == tape.smem_bytes(rows) <= qt.SMEM_BYTES
    # a row's lanes walk each of the eight LogUp transitions (some 17,000
    # instructions each) in a segment of its own, in under 600 steps
    steps = np.diff(tape.seg_offsets) // tape.lanes
    assert int(steps.max()) < 600 and tape.stats["max_steps"] == int(steps.max())
    assert tape.stats["instructions"] > 16937
    # a layout of more slots fits at fewer rows a block
    wide = qt.Tape(**{**tape.__dict__, "seg_slots": np.full(tape.segments, 6000, np.int32), "device_arrays": {}})
    assert 1 <= quotient_cuda.launch_shape(wide, m)[1] < rows
    # one that fits nowhere raises with the AIR's name
    huge = qt.Tape(**{**tape.__dict__, "seg_slots": np.full(tape.segments, 60000, np.int32), "device_arrays": {}})
    with pytest.raises(ValueError, match="EvmCpuAir"):
        quotient_cuda.launch_shape(huge, m)


def test_record_caps_segment_slots(monkeypatch):
    """Under a cap of 500 slots and 1,200 columns the recorder cuts the
    EVM CPU table into more segments until every one fits (a LogUp row
    alone holds some 360 slots and reads some 1,070 columns at L = 32)."""
    graph = _graph("EvmCpuAir")
    free = qt.tape_of(graph, 128, segments=16)
    assert free.stats["max_slots"] > 500 and free.stats["max_columns"] > 1200
    monkeypatch.setattr(qt, "MAX_SEGMENT_SLOTS", 500)
    monkeypatch.setattr(qt, "MAX_SEGMENT_COLUMNS", 1200)
    tape = qt.tape_of(graph, 128, segments=16)
    assert tape.fits() and tape.segments > free.segments
    assert int(tape.seg_slots.max()) <= 500 and tape.stats["max_columns"] <= 1200


def test_record_widens_where_segments_recompute():
    """At one lane a row the column budget would cut Poseidon2CallsAir
    (16,384 LDE rows) into segments that recompute dozens of times what
    one segment computes; unless L is asked for, the recorder takes more
    lanes until they recompute at most MAX_RECOMPUTE times."""
    graph = _graph("Poseidon2CallsAir")
    whole = lambda t: t.stats["arith_one_segment"] + t.rows  # noqa: E731
    narrow = qt.tape_of(graph, 1 << 14, lanes=1)
    assert narrow.lanes == 1 and narrow.stats["instructions"] > 10 * whole(narrow)
    tape = qt.tape_of(graph, 1 << 14)
    assert qt.lanes_for(1 << 14) == 1 < tape.lanes
    assert tape.stats["instructions"] <= qt.MAX_RECOMPUTE * whole(tape)


def test_record_widens_a_row_that_fits_no_warp(monkeypatch):
    """A constraint row whose columns do not fit one warp's rows (32 at one
    lane) in shared memory takes more lanes a row, so fewer rows a warp."""

    class Wide(Air):
        width = 200

        def eval(self, b):
            b.all_rows(b.block_rowsum(b.local_block(range(200))))

    graph = qt.record_graph(Wide())
    tape = qt.tape_of(graph, 1 << 16)
    assert tape.lanes == qt.lanes_for(1 << 16) == 1 and tape.stats["max_columns"] == 200
    monkeypatch.setattr(qt, "SMEM_BYTES", tape.smem_bytes(4))
    narrow = qt.tape_of(graph, 1 << 16)
    assert narrow.lanes == 8 and narrow.fits()
