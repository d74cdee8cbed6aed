"""The port's constraint checker (``stark/debug.py``) against the JAX
package's, on the CPU.

``check_constraints`` evaluates every constraint of an AIR on a trace in
exact host arithmetic and names the constraints that fail and their rows.
Each case builds the same statement through both packages, from the same
inputs or seed, and compares the JAX checker on the JAX package's trace
with the port's checker on the port's trace, string for string
(tolerance 0):

- satisfied traces of every AIR family the port has: the golden call
  tree's 17 tables (``stark_evm_call_tree.json``), the full-coverage
  ``frame`` of ``tests/test_evm_air.py`` (14 tables), ``fib`` and
  ``transcript`` from their goldens' inputs, the containment system's
  three tables on ``tests/test_containment.py``'s chain of messages, the
  recursion circuit's gate and call tables on a build like
  ``tests/test_circuit.py``'s, and the LogUp test AIRs (lookup,
  permutation, bus): both lists are ``[]``;
- tampered traces, the perturbations of the JAX package's tamper tests
  that the checker itself reports (``tests/test_evm_air.py``,
  ``tests/test_evm_call.py``, ``tests/test_containment.py``), applied
  through each package's own column constants: both lists are equal and
  not empty;
- traces with many failures, cut at ``max_report`` 3 and the default 10.
"""

import importlib
import json
import os
import types

import numpy as np
import pytest
import torch

import test_containment as tcon
import test_torch_evm as tte
from raiko_tpu_torch.fields import babybear as bb
from raiko_tpu_torch.testing.goldens import call_tree_tables, golden_air

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SEED = 20261018


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pkg(root: str) -> types.SimpleNamespace:
    """One package's checker and AIR modules, by their common relative paths."""
    names = {
        "debug": "stark.debug", "circuit": "stark.circuit", "ef": "fields.babybear_ext",
        "ea": "stark.airs.evm_air", "ec": "stark.airs.evm_call", "es": "stark.airs.evm_storage",
        "ar": "stark.airs.evm_arith", "cp": "stark.airs.evm_copy", "con": "stark.airs.containment",
        "kec": "stark.airs.keccak_air", "gate": "stark.airs.circuit_air", "calls": "stark.airs.poseidon2_calls",
        "fib": "stark.airs.fib", "p2air": "stark.airs.poseidon2_air", "lookup": "stark.airs.lookup",
        "perm": "stark.airs.permcheck", "bus": "stark.airs.bus",
    }
    return types.SimpleNamespace(name=root, **{k: importlib.import_module(f"{root}.{v}") for k, v in names.items()})


PORT = _pkg("raiko_tpu_torch")
JAX = _pkg("raiko_tpu")


def _golden(case: str) -> dict:
    with open(os.path.join(GOLDEN, f"stark_{case}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def challenges():
    rng = np.random.default_rng(SEED)
    return [tuple(int(v) for v in rng.integers(1, bb.P, 4)) for _ in range(PORT.ea.NUM_CHALLENGES)]


def _check(pkg, air, trace, publics, challenges, **kw) -> list[str]:
    return pkg.debug.check_constraints(air, trace, publics, challenges, **kw)


def _both(tables, jtables, challenges, **kw) -> list[tuple[str, list[str]]]:
    """(AIR name, violations) of every table, through the port and through
    JAX; asserts the two lists are equal, table by table."""
    assert [type(t[0]).__name__ for t in tables] == [type(t[0]).__name__ for t in jtables]
    out = []
    for (air, trace, publics), (jair, jtrace, jpublics) in zip(tables, jtables):
        name = type(air).__name__
        np.testing.assert_array_equal(trace, jtrace, err_msg=name)
        got = _check(PORT, air, trace, publics, challenges, **kw)
        want = _check(JAX, jair, jtrace, jpublics, challenges, **kw)
        assert got == want, (name, got, want)
        out.append((name, got))
    return out


# --- the families, built through either package


def _tree_root(pkg):
    """The golden call tree's root frame, executed by pkg."""
    inputs = _golden("evm_call_tree")["inputs"]
    ea = pkg.ea
    return ea.execute_frame(bytes.fromhex(inputs["caller"]), ea.FrameEnv(**inputs["env"]), inputs["gas"],
                            world={inputs["callee_address"]: {"code": bytes.fromhex(inputs["callee"])}},
                            warm_addresses=set())


def _call_tree(pkg) -> list:
    if pkg is PORT:  # as chip_smoke.py builds them
        return call_tree_tables(_golden("evm_call_tree")["inputs"])
    return tte._tables(pkg.ea, pkg.ec, _tree_root(pkg))[1]


def _frame(pkg) -> list:
    return tte._tables(pkg.ea, pkg.ec, tte._execute(pkg.ea, "frame"))[1]


def _golden_air(pkg, case: str) -> list:
    inputs = _golden(case)["inputs"]
    if pkg is PORT:
        return [golden_air(case, inputs)]
    if case == "fib":
        trace, publics = pkg.fib.FibAir.trace(inputs["log_n"], inputs["a"], inputs["b"])
        return [(pkg.fib.FibAir(), trace, publics)]
    air = pkg.p2air.Poseidon2TranscriptAir(inputs["blocks"])
    return [(air, air.trace(), air.publics_for(air.compute_digest()))]


def _containment(pkg) -> list:
    """The sponge, byte and claim tables of test_containment's chain."""
    msgs, claims, mults = tcon._chain_messages(np.random.default_rng(9))
    sponge = pkg.kec.KeccakSpongeV2Air.from_messages(msgs, bind_root=True)
    bytetab = pkg.con.ByteCodeAir([len(pkg.con.pad_keccak(m)) for m in msgs])
    claimt = pkg.con.ContainAir(len(msgs) - 1)
    return [
        (sponge, sponge.trace(), sponge.publics()),
        (bytetab, bytetab.trace(msgs, mults), []),
        (claimt, claimt.trace(claims), []),
    ]


def _circuit(pkg) -> list:
    """test_circuit's recursion-circuit build: its gate and call tables."""
    ef = pkg.ef
    b = pkg.circuit.CircuitBuilder(True)
    x, y = b.input_base(5), b.input_base(7)
    z = b.mul(x, y)
    w = b.axpy(z, (3, 0, 0, 0), y)
    b.assert_eq(w, (56, 0, 0, 0))
    b.assert_eq(b.mul(w, b.inv(w)), ef.H_ONE)
    bit = b.bit_input(1)
    b.assert_eq(b.select(bit, x, y), (5, 0, 0, 0))
    lanes = [x, y, z, w] + [b.const_wire(i) for i in range(4)]
    lanes += [pkg.circuit.FreeLane(100 + i) for i in range(8)]
    out = b.perm_call(lanes, swap=bit)
    b.assert_eq(b.add(out[0], out[1]), b.add(out[1], out[0]))
    b.perm_call([(i, 0, 0, 0) for i in range(16)])
    out2 = b.perm_call(out, swap=None)
    b.assert_eq(out2[3], out2[3])
    bun = b.finalize()
    return [(pkg.gate.CircuitAir(bun.gate_fixed), bun.gate_trace, []),
            (pkg.calls.Poseidon2CallsAir(bun.call_fixed), bun.call_trace, [])]


def _lookup_trace(pkg, seed: int = 13):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, bb.P, 64).tolist()
    looked = [table[int(i)] for i in rng.integers(0, 64, 64)]
    return pkg.lookup.LookupAir.make_trace(looked, table)


def _perm_trace(pkg):
    inputs = _golden("permcheck")["inputs"]
    return pkg.perm.PermutationAir.make_trace(inputs["a"], inputs["b"])


def _bus_traces(pkg):
    sent = np.random.default_rng(31).integers(0, bb.P, 64).tolist()
    return (pkg.bus.BusTableAir.make_trace(sent, [2] * 32 + [0] * 32),
            pkg.bus.BusTableAir.make_trace(sent[:32], [2] * 32))


def _logup(pkg) -> list:
    t_send, t_recv = _bus_traces(pkg)
    return [(pkg.lookup.LookupAir(), _lookup_trace(pkg), []),
            (pkg.perm.PermutationAir(), _perm_trace(pkg), []),
            (pkg.bus.BusTableAir(1), t_send, []),
            (pkg.bus.BusTableAir(-1), t_recv, [])]


FAMILIES = {
    "call_tree": (_call_tree, 17),
    "frame": (_frame, 14),
    "fib": (lambda pkg: _golden_air(pkg, "fib"), 1),
    "transcript": (lambda pkg: _golden_air(pkg, "transcript"), 1),
    "containment": (_containment, 3),
    "circuit": (_circuit, 2),
    "logup": (_logup, 4),
}


# the families whose AIRs take fewer EF challenges than the EVM tables'
CHALLENGES = {"circuit": 2, "logup": 1}


def _family_challenges(family: str, challenges):
    return challenges[:CHALLENGES.get(family, len(challenges))]


@pytest.fixture(scope="module")
def built():
    """Each family's tables through either package, built once: the
    tests below copy a trace they change."""
    cache = {}

    def tables(family: str):
        if family not in cache:
            build = FAMILIES[family][0]
            cache[family] = (build(PORT), build(JAX))
        return cache[family]

    return tables


@pytest.mark.parametrize("family", list(FAMILIES))
def test_satisfied_family_checks_clean(family, built, challenges):
    count = FAMILIES[family][1]
    out = _both(*built(family), _family_challenges(family, challenges))
    assert len(out) == count
    assert [v for _, v in out] == [[]] * count, out


# --- tampered traces: the JAX tamper tests' perturbations


def _rows(ea, t, op: str):
    return np.where(t[:, ea.FLAG0 + ea.FLAG_IDX[op]] == 1)[0]


def _call_row(pkg) -> int:
    """The golden call tree's CALL row in its root CPU table."""
    return [i for i, st in enumerate(_tree_root(pkg).steps) if st.name == "call"][0]


def _add_result(pkg, air, t):
    t[_rows(pkg.ea, t, "add")[0], pkg.ea.C0] ^= 1


def _gas_bit(pkg, air, t):
    t[3, pkg.ea.GASB0] ^= 1


def _opcode_class(pkg, air, t):
    """An ADD row claiming to be a SUB."""
    ea = pkg.ea
    r = _rows(ea, t, "add")[0]
    t[r, ea.FLAG0 + ea.FLAG_IDX["add"]] = 0
    t[r, ea.FLAG0 + ea.FLAG_IDX["sub"]] = 1


def _mul_result(pkg, air, t):
    t[_rows(pkg.ea, t, "mul")[0], pkg.ea.C0 + 8] ^= 1


def _div_quotient(pkg, air, t):
    ea = pkg.ea
    t[np.where((t[:, ea.FLAG0 + ea.FLAG_IDX["div"]] == 1) & (t[:, ea.TAKEN] == 1))[0][0], ea.C0] ^= 1


def _stack_read(pkg, air, t):
    ea = pkg.ea
    t[np.where((t[:, ea.SK_SA] == 1) & (t[:, ea.SK_IW] == 0))[0][0], ea.SK_V0 + 3] ^= 1


def _fresh_memory_read(pkg, air, t):
    t[np.where(t[:, pkg.ea.MR_FR] == 1)[0][0], pkg.ea.MR_V0 + 11] = 1


def _storage_warm_read(pkg, air, t):
    es = pkg.es
    t[np.where((air.fixed_columns(air.n)[es.SF_SA] == 1) & (t[:, es.ST_IW] == 0))[0][0], es.ST_V0 + 3] ^= 1


def _storage_gas_case(pkg, air, t):
    es = pkg.es
    r = np.where(t[:, es.ST_G2] == 1)[0][0]
    t[r, es.ST_G2] = 0
    t[r, es.ST_G1] = 1


def _sdiv_sign(pkg, air, t):
    t[np.where(t[:, pkg.ar.ARF_SDIV] == 1)[0][0], pkg.ar.AR_SDC] ^= 1


def _exp_bit(pkg, air, t):
    ar = pkg.ar
    t[np.where(air.fixed_columns(air.n)[ar.XF_START] == 1)[0][0] + 5, ar.AR_BIT] ^= 1


def _copy_zero_fill(pkg, air, t):
    cp = pkg.cp
    fx = air.fixed_columns(air.n)
    t[np.where((fx[cp.CPF_INB] == 0) & (fx[cp.CPF_ACTIVE] == 1))[0][0], cp.CP_W0 + 5] = 1


def _copy_old_word(pkg, air, t):
    """An old word on a copy row that is not the byte tail."""
    cp = pkg.cp
    fx = air.fixed_columns(air.n)
    t[np.where((fx[cp.CPF_TAIL] == 0) & (fx[cp.CPF_ACTIVE] == 1))[0][0], cp.CP_OLD0] = 1


def _call_gas_forwarding(pkg, air, t):
    """The CALL forwarding more gas than the 63/64 rule lets it."""
    ea = pkg.ea
    r = _call_row(pkg) + 1  # the callret row holds the forwarding scratch
    bit = next(b for b in range(ea.MAX_GAS_LOG) if t[r, ea.SCRATCH0 + ea.RW_GASIN0 + b] == 0)
    t[r, ea.SCRATCH0 + ea.RW_GASIN0 + bit] = 1


def _call_cold_flag(pkg, air, t):
    """The CALL claiming its cold callee address was warm."""
    r = _call_row(pkg)
    assert t[r, pkg.ea.SCOLD] == 1
    t[r, pkg.ea.SCOLD] = 0


def _byte_bits(pkg, air, t):
    t[3, 0] = (int(t[3, 0]) + 1) % bb.P  # a byte that is not its bits


def _lookup_multiplicity(pkg, air, t):
    t[3, pkg.lookup.COL_M] = (int(t[3, pkg.lookup.COL_M]) + 1) % bb.P


def _not_a_permutation(pkg, air, t):
    t[5, pkg.perm.COL_B] = (int(t[5, pkg.perm.COL_B]) + 1) % bb.P


def _forged_bus_value(pkg, air, t):
    """The send table claiming another bus value than its running sum's."""
    return {"bus": [(1, 2, 3, 4)]}


# name -> (family, AIR class, perturbation): a perturbation changes the
# trace in place or returns the checker's changed keyword arguments
TAMPERS = {
    "add_result": ("call_tree", "EvmCpuAir", _add_result),
    "gas_bit": ("call_tree", "EvmCpuAir", _gas_bit),
    "opcode_class": ("call_tree", "EvmCpuAir", _opcode_class),
    "mul_result": ("frame", "EvmCpuAir", _mul_result),
    "div_quotient": ("frame", "EvmCpuAir", _div_quotient),
    "stack_read": ("frame", "EvmStackAir", _stack_read),
    "fresh_memory_read": ("frame", "MemRamAir", _fresh_memory_read),
    "storage_warm_read": ("frame", "EvmStorageAir", _storage_warm_read),
    "storage_gas_case": ("frame", "EvmStorageAir", _storage_gas_case),
    "sdiv_sign": ("frame", "ArithAir", _sdiv_sign),
    "exp_bit": ("frame", "ArithAir", _exp_bit),
    "copy_zero_fill": ("frame", "EvmCopyAir", _copy_zero_fill),
    "copy_old_word": ("frame", "EvmCopyAir", _copy_old_word),
    "call_gas_forwarding": ("call_tree", "EvmCpuAir", _call_gas_forwarding),
    "call_cold_flag": ("call_tree", "EvmCpuAir", _call_cold_flag),
    "byte_bits": ("containment", "ByteCodeAir", _byte_bits),
    "lookup_multiplicity": ("logup", "LookupAir", _lookup_multiplicity),
    "not_a_permutation": ("logup", "PermutationAir", _not_a_permutation),
    "forged_bus_value": ("logup", "BusTableAir", _forged_bus_value),
}


@pytest.mark.parametrize("case", list(TAMPERS))
def test_tampered_trace_caught_alike(case, built, challenges):
    family, cls, perturb = TAMPERS[case]
    chal = _family_challenges(family, challenges)
    got = []
    for pkg, tables in zip((PORT, JAX), built(family)):
        air, trace, publics = next(t for t in tables if type(t[0]).__name__ == cls)
        t = trace.copy()
        kw = perturb(pkg, air, t) or {}
        assert kw or not np.array_equal(t, trace)
        got.append(_check(pkg, air, t, publics, chal, **kw))
    assert got[0], case
    assert got[0] == got[1]


# --- max_report: traces with many failures


# family -> the AIR class whose trace is replaced by random values
REPORTS = {"transcript": "Poseidon2TranscriptAir", "circuit": "Poseidon2CallsAir"}


@pytest.mark.parametrize("max_report", [3, None])
@pytest.mark.parametrize("table", list(REPORTS))
def test_max_report_cuts_alike(table, max_report, built, challenges):
    """A random trace in place of a table's: max_report violations (the
    default 10), the same in both."""
    kw = {} if max_report is None else {"max_report": max_report}
    randomised = []
    for tables in built(table):
        air, trace, publics = next(t for t in tables if type(t[0]).__name__ == REPORTS[table])
        rng = np.random.default_rng(SEED + 1)
        randomised.append([(air, rng.integers(0, bb.P, trace.shape, dtype=np.uint64).astype(np.uint32), publics)])
    (_, got), = _both(*randomised, _family_challenges(table, challenges), **kw)
    assert len(got) == (max_report or 10)
