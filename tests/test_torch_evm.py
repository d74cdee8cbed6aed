"""The port's EVM frame statement and its prestate binding, against the JAX
package, on the CPU.

The EVM AIRs (``stark/airs/evm_*.py``) are host numpy in both packages.
On the fixtures of ``tests/test_evm_air.py`` (``frame``, ``ret_frame``) and
``tests/test_evm_call.py`` (the call ``tree``, STATICCALL, DELEGATECALL,
the CALL variants, a value CALL, a reverting callee, CREATE/CREATE2 and
the account-state family), built from the same inputs through both
packages, ``execute_frame``'s gas and steps, each frame's public record
and, for every table of every frame, the trace, aux trace, bus values,
publics and fixed columns are equal (tolerance 0).

The call tree of ``test_call_tree_prove_verify_roundtrip``, proven by the
port's ``prove_call_tree(..., "cpu")``, equals the JAX payload of
``tools/make_stark_goldens.py`` (``stark_evm_call_tree.json``) byte for
byte as ``json.dumps(payload, sort_keys=True)``; the port's verifier
accepts it and rejects a tampered callee public.

The prestate tests are the port's copies of ``tests/test_prestate.py``,
with the keccak STARK stubbed in both packages; where they build a
payload, the port's equals the JAX package's.

The ``slow`` test proves the 10-tx block of ``stark_block_10tx_evm.json``
under the default config on the CPU and the ``cuda`` test on a card, each
in a subprocess under the golden's ``PYTHONHASHSEED``; each payload must
hash as the JAX golden's, with every covered frame proven, and the
port's ``verify_payload`` must reject the first frame's ``gas_f`` lowered
by one.
"""

import copy
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import test_evm_air as tea
import test_evm_call as tec
from raiko_tpu.mpt import EMPTY_ROOT as J_EMPTY_ROOT
from raiko_tpu.mpt import trie as jtrie
from raiko_tpu.proto import rlp as jrlp
from raiko_tpu.proto import types as jtypes
from raiko_tpu.provers import prestate as jprestate
from raiko_tpu.provers import tpu_stark as jts
from raiko_tpu.stark.airs import evm_air as jea
from raiko_tpu.stark.airs import evm_call as jec
from raiko_tpu.utils import keccak256
from raiko_tpu_torch.fields import babybear as bb
from raiko_tpu_torch.mpt import EMPTY_ROOT
from raiko_tpu_torch.mpt import trie as ptrie
from raiko_tpu_torch.proto import rlp as prlp
from raiko_tpu_torch.proto import types as ptypes
from raiko_tpu_torch.provers import prestate
from raiko_tpu_torch.provers import tpu_stark as ts
from raiko_tpu_torch.stark.airs import evm_air as ea
from raiko_tpu_torch.stark.airs import evm_call as ec

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(case: str) -> dict:
    with open(os.path.join(GOLDEN, f"stark_{case}.json")) as f:
        return json.load(f)


def _sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


# --- the fixtures, built through either package


def _env(mod, env):
    return mod.FrameEnv(**dataclasses.asdict(env))


# the CALL variants of test_call_variants_gas_matches_interpreter
_SB_CHILD = bytes([0x47, 0x60, 0x00, 0x52, 0x60, 0x20, 0x60, 0x00, 0xF3])
_STOR_CHILD = bytes([
    0x60, 0x07, 0x60, 0x01, 0x55, 0x60, 0x01, 0x54,
    0x60, 0x00, 0x52, 0x60, 0x20, 0x60, 0x00, 0xF3,
])
_REVC = bytes([0x60, 0x55, 0x60, 0x00, 0x52, 0x60, 0x20, 0x60, 0x00, 0xFD])
_VARIANTS = bytes([
    0x60, 0x20, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00,
    0x60, 0xBB, 0x61, 0xFF, 0xFF, 0xFA, 0x50,
    0x60, 0x20, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00,
    0x60, 0xCB, 0x61, 0xFF, 0xFF, 0xF4, 0x50,
    0x60, 0x20, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00, 0x60, 0x07,
    0x60, 0xEE, 0x61, 0xFF, 0xFF, 0xF1, 0x50,
    0x60, 0x00, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00, 0x60, 0x03,
    0x60, 0xDD, 0x61, 0xFF, 0xFF, 0xF1, 0x50,
    0x60, 0x20, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00,
    0x60, 0xCC, 0x61, 0xFF, 0xFF, 0xF1, 0x50,
    0x60, 0xDD, 0x31, 0x50, 0x00,
])
_VARIANT_CODES = {0xAA: _VARIANTS, 0xBB: tec.CALLEE, 0xCB: _STOR_CHILD, 0xEE: _SB_CHILD, 0xCC: _REVC}
_SC = bytes([0x60, 0x20, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00, 0x60, 0xBB, 0x61, 0xFF, 0xFF, 0xFA, 0x00])
_DC = bytes([0x60, 0x20, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00, 0x60, 0xBB, 0x61, 0xFF, 0xFF, 0xF4, 0x00])
_VALUE_CALLER = bytes([
    0x60, 0x00, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00, 0x60, 0x01,
    0x60, 0xBB, 0x61, 0xFF, 0xFF, 0xF1, 0x00,
])
_REVERTING = bytes([0x60, 0x00, 0x60, 0x00, 0xFD])
_REVERT_CALLER = bytes([
    0x60, 0x00, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00,
    0x60, 0xCC, 0x61, 0xFF, 0xFF, 0xF1, 0x00,
])

# case -> (code, env, gas, keyword arguments of execute_frame)
CASES = {
    "frame": (tea.full_coverage_program(), tea.ENV, 200_000,
              {"calldata": tea.CALLDATA, "storage": dict(tea.STORAGE)}),
    "ret_frame": (tea.RET_CODE, tea.ENV, 50_000, {"calldata": tea.CALLDATA}),
    "tree": (tec.CALLER, tec.ENV, 100_000, {"world": tec.WORLD, "warm_addresses": set()}),
    "staticcall": (_SC, tec.ENV, 100_000, {"world": tec.WORLD, "warm_addresses": set()}),
    "delegatecall": (_DC, tec.ENV, 100_000, {"world": tec.WORLD, "warm_addresses": set()}),
    "call_variants": (_VARIANTS, tec.ENV, 300_000, {
        "world": {ai: {"code": c, "storage": {1: 0} if ai == 0xAA else {}} for ai, c in _VARIANT_CODES.items()},
        "warm_addresses": set(), "storage": {1: 0}, "balances": {0xAA: 1000, 0xEE: 50, 0xDD: 1}}),
    "value_call": (_VALUE_CALLER, tec.ENV, 100_000,
                   {"world": tec.WORLD, "warm_addresses": set(), "balances": {0xAA: 10, 0xBB: 1}}),
    "reverting_callee": (_REVERT_CALLER, tec.ENV, 100_000,
                         {"world": {0xCC: {"code": _REVERTING}}, "warm_addresses": set()}),
    "create": (tec._create_fixture_code()[0], tec.ENV, 400_000,
               {"world": {}, "warm_addresses": set(), "nonces": {0xAA: 1}, "balances": {0xAA: 50}}),
    "account_state": (tec.ACCT_CODE, tec.ACCT_ENV, 100_000,
                      {"acct_ctx": tec.ACCT_CTX, "balances": dict(tec.ACCT_BAL)}),
}


def _execute(mod, case: str):
    code, env, gas, kw = CASES[case]
    return mod.execute_frame(code, _env(mod, env), gas, **copy.deepcopy(kw))


def _tables(mod, call_mod, root):
    """Every table of the tree, as prove_call_tree builds them."""
    fts = mod.flatten_call_tree(root)
    tables = []
    for ft in fts:
        tables.extend(mod.frame_tables(ft))
        tables.extend(mod._frame_extra_tables(ft))
    groups, events = mod.balance_journal(fts)
    if groups:
        bal = call_mod.EvmBalanceAir(groups)
        tables.append((bal, bal.trace(events), bal.publics()))
    return fts, tables


@pytest.fixture(scope="module")
def challenges():
    rng = np.random.default_rng(20261017)
    return [tuple(int(v) for v in rng.integers(1, bb.P, 4)) for _ in range(ea.NUM_CHALLENGES)]


def test_constants_equal_jax():
    for name in ("NUM_CHALLENGES", "NUM_BUS", "ENV_OPS", "MAX_KECCAK_CALLS", "BUS_CQ", "BUS_STOR"):
        assert getattr(ea, name) == getattr(jea, name), name


@pytest.mark.parametrize("case", list(CASES))
def test_air_arrays_equal_jax(case, challenges):
    """Gas, steps, frame records and every table's arrays, tolerance 0."""
    root, jroot = _execute(ea, case), _execute(jea, case)
    assert root.gas_f == jroot.gas_f and root.sp_f == jroot.sp_f
    assert [dataclasses.asdict(s) for s in root.steps] == [dataclasses.asdict(s) for s in jroot.steps]
    fts, tables = _tables(ea, ec, root)
    jfts, jtables = _tables(jea, jec, jroot)
    assert [ea.frame_record(ft) for ft in fts] == [jea.frame_record(ft) for ft in jfts]
    assert [type(t[0]).__name__ for t in tables] == [type(t[0]).__name__ for t in jtables]
    for (air, trace, publics), (jair, jtrace, jpublics) in zip(tables, jtables):
        name = type(air).__name__
        np.testing.assert_array_equal(trace, jtrace, err_msg=name)
        assert [int(v) for v in publics] == [int(v) for v in jpublics], name
        assert (air.width, air.aux_width, air.num_bus_values) == (jair.width, jair.aux_width, jair.num_bus_values)
        n = trace.shape[0]
        fixed, jfixed = air.fixed_columns(n), jair.fixed_columns(n)
        assert (fixed is None) == (jfixed is None), name
        if fixed is not None:
            np.testing.assert_array_equal(fixed, jfixed, err_msg=name)
        if air.aux_width:
            np.testing.assert_array_equal(air.aux_trace(trace, challenges), jair.aux_trace(jtrace, challenges),
                                          err_msg=name)
        assert air.bus_values(trace, challenges) == jair.bus_values(jtrace, challenges), name


# --- one call tree's proof against the JAX golden


@pytest.fixture(scope="module")
def tree_payload():
    g = _golden("evm_call_tree")
    inp = g["inputs"]
    root = ea.execute_frame(bytes.fromhex(inp["caller"]), ea.FrameEnv(**inp["env"]), inp["gas"],
                            world={inp["callee_address"]: {"code": bytes.fromhex(inp["callee"])}},
                            warm_addresses=set())
    return g, ea.prove_call_tree(root, "cpu")


def test_golden_tree_is_the_test_fixture():
    inp = _golden("evm_call_tree")["inputs"]
    assert bytes.fromhex(inp["caller"]) == tec.CALLER
    assert {inp["callee_address"]: {"code": bytes.fromhex(inp["callee"])}} == tec.WORLD
    assert ea.FrameEnv(**inp["env"]) == _env(ea, tec.ENV)


def test_call_tree_proof_equals_jax_golden(tree_payload):
    g, payload = tree_payload
    assert payload["kind"] == "evm-call-tree-v1" and len(payload["frames"]) == g["frames"] == 2
    assert [[p["width"], p["log_n"]] for p in payload["starks"]] == g["tables"]
    assert [p["trace_root"] for p in payload["starks"]] == g["roots"]
    assert _sha(payload) == g["sha256"]


def test_call_tree_verifies_and_rejects_tampered_callee(tree_payload):
    _, payload = tree_payload
    assert ea.verify_frame_payload(payload, "cpu")
    bad = copy.deepcopy(payload)
    bad["frames"][1]["gas0"] += 1
    assert not ea.verify_frame_payload(bad, "cpu")
    # the statement's structure is checked before any proof
    evm = {"kind": "evm-frames-v1", "total": 1, "covered": 1, "frames": [payload]}
    assert not ts.verify_evm_frames_payload(dict(evm, covered=2), "cpu")
    assert not ts.verify_evm_frames_payload(dict(evm, kind="evm-frames-v0"), "cpu")
    assert not ts.verify_evm_frames_payload(dict(evm, frames=[], covered=0), "cpu")


# --- prestate: the port's copies of tests/test_prestate.py

ADDR = b"\xaa" * 20
ADDR2 = b"\xbb" * 20


class _Pkg:
    """One package's prestate, trie and type modules."""

    def __init__(self, prestate_mod, trie_mod, rlp_mod, types_mod, empty_root, tpu_stark_mod):
        self.prestate, self.trie, self.rlp, self.types = prestate_mod, trie_mod, rlp_mod, types_mod
        self.empty_root, self.tpu_stark = empty_root, tpu_stark_mod


PORT = _Pkg(prestate, ptrie, prlp, ptypes, EMPTY_ROOT, ts)
JAX = _Pkg(jprestate, jtrie, jrlp, jtypes, J_EMPTY_ROOT, jts)


def _mk_world(pkg: _Pkg, slots: dict[int, int]):
    """parent state trie with one contract account holding `slots`."""
    st = pkg.trie.MptNode.null()
    for slot, val in slots.items():
        if val:
            st.insert(pkg.trie.to_nibs(keccak256(slot.to_bytes(32, "big"))), pkg.rlp.encode(val))
    state = pkg.trie.MptNode.null()
    acct = pkg.types.Account(nonce=1, balance=100, storage_root=st.hash())
    state.insert(pkg.trie.to_nibs(keccak256(ADDR)), acct.encode())
    # a second, unrelated account so paths have branches
    state.insert(pkg.trie.to_nibs(keccak256(ADDR2)),
                 pkg.types.Account(balance=5, storage_root=pkg.empty_root).encode())
    header = pkg.types.BlockHeader(state_root=state.hash(), number=7)
    return state, {ADDR: st}, header


def _mk_collect(state, storage, header, frames):
    return {"parent_state_trie": state, "parent_storage": storage, "parent_header": header, "frames": frames}


def _fake_verify(kec, root=None):
    if kec.get("kind") != "keccak-mpt-v1" or not kec.get("stubbed"):
        return False
    msgs = [bytes.fromhex(m) for m in kec["messages"]]
    if root is not None and keccak256(msgs[0]) != root:
        return False
    blob = b""
    for m in msgs:
        if blob and keccak256(m) not in blob:
            return False
        blob += m
    return True


def _fake_prove(msgs, root):
    assert keccak256(msgs[0]) == root
    return {"kind": "keccak-mpt-v1", "state_root": root.hex(), "messages": [m.hex() for m in msgs],
            "stubbed": True}


@pytest.fixture
def stub_keccak(monkeypatch):
    """Replace the batch-keccak STARK with a structural stub (host keccak
    only) in both packages; the port's take the device and ignore it."""
    monkeypatch.setattr(jts, "prove_keccak_batch_public", _fake_prove)
    monkeypatch.setattr(jts, "verify_mpt_payload", _fake_verify)
    monkeypatch.setattr(ts, "prove_keccak_batch_public", lambda msgs, root, device: _fake_prove(msgs, root))
    monkeypatch.setattr(ts, "verify_mpt_payload", lambda kec, device, root=None: _fake_verify(kec, root))


def _prove_both(slots, frames_for, world=None):
    """The prestate slot built by the port and by JAX from the same world;
    the two must be equal.  Returns (port slot, port header)."""
    out = []
    for pkg in (PORT, JAX):
        state, storage, header = world(pkg) if world else _mk_world(pkg, slots)
        collect = _mk_collect(state, storage, header, frames_for(pkg))
        device = ("cpu",) if pkg is PORT else ()
        out.append((pkg.prestate.prove_prestate(collect, *device), header))
    assert out[0][0] == out[1][0]
    return out[0]


def _payload(ps, header, frames_storage):
    """payload skeleton: chain slot anchored at the parent header +
    fake evm frames with the given storage groups."""
    return {
        "chain": {"state_root": keccak256(header.encode()).hex()},
        "evm": {"frames": [{"frames": [{"env": {"address": "0x" + ADDR.hex()}, "storage": groups}]}
                           for groups in frames_storage]},
        "prestate": ps,
    }


def _verify(payload) -> bool:
    got = prestate.verify_prestate_binding(payload, "cpu")
    assert got == jprestate.verify_prestate_binding(payload)
    return got


def test_binding_roundtrip_and_chaining(stub_keccak):
    a = int.from_bytes(ADDR, "big")
    ps, header = _prove_both({1: 5, 2: 0}, lambda pkg: [{"address": a, "storage": {1: 5, 2: 0}},
                                                       {"address": a, "storage": {1: 9}}])
    assert ps is not None and ps["kind"] == "prestate-v1"
    good = _payload(ps, header, [
        [[hex(1), hex(5), 2, 0, hex(9)], [hex(2), hex(0), 1, 0, hex(3)]],
        [[hex(1), hex(9), 1, 0, hex(4)]],
    ])
    assert _verify(good)
    # wrong first original (not the pre-state value)
    assert not _verify(_payload(ps, header, [[[hex(1), hex(6), 2, 0, hex(9)]]]))
    # broken chain: frame 1's original != frame 0's final
    assert not _verify(_payload(ps, header, [[[hex(1), hex(5), 2, 0, hex(9)]], [[hex(1), hex(8), 1, 0, hex(4)]]]))
    # absent slot must bind to zero
    assert not _verify(_payload(ps, header, [[[hex(2), hex(7), 1, 0, hex(7)]]]))


def test_binding_rejects_tampered_anchor(stub_keccak):
    a = int.from_bytes(ADDR, "big")
    ps, header = _prove_both({1: 5}, lambda pkg: [{"address": a, "storage": {1: 5}}])
    state, _, _ = _mk_world(PORT, {1: 5})
    groups = [[[hex(1), hex(5), 1, 0, hex(5)]]]
    # parent header not matching the chain statement's root digest
    other = ptypes.BlockHeader(state_root=state.hash(), number=8)
    bad = _payload(ps, header, groups)
    bad["chain"] = {"state_root": keccak256(other.encode()).hex()}
    assert not _verify(bad)
    # header swapped for one with a different state root
    world2 = _mk_world(PORT, {1: 6})
    bad = _payload(dict(ps, parent_header=world2[2].encode().hex()), header, groups)
    bad["chain"] = {"state_root": keccak256(world2[2].encode()).hex()}
    assert not _verify(bad)
    # path node dropped from the proven message set
    bad_ps = copy.deepcopy(ps)
    bad_ps["keccak"]["messages"] = bad_ps["keccak"]["messages"][:1]
    assert not _verify(_payload(bad_ps, header, groups))
    # missing prestate slot while frames claim storage
    bad = _payload(None, header, groups)
    assert not _verify(bad)


def test_no_storage_frames_need_no_prestate(stub_keccak):
    payload = {
        "chain": {"state_root": "00" * 32},
        "evm": {"frames": [{"frames": [{"env": {"address": "0x0"}, "storage": []}]}]},
    }
    assert _verify(payload)


def test_absent_account_binds_zero(stub_keccak):
    """A frame at an address missing from the pre-state: exclusion path,
    originals must be zero."""
    missing = b"\xcc" * 20
    ps, header = _prove_both({1: 5}, lambda pkg: [{"address": int.from_bytes(missing, "big"), "storage": {3: 0}}])
    payload = {
        "chain": {"state_root": keccak256(header.encode()).hex()},
        "evm": {"frames": [{"frames": [{"env": {"address": "0x" + missing.hex()},
                                        "storage": [[hex(3), hex(0), 1, 0, hex(2)]]}]}]},
        "prestate": ps,
    }
    assert _verify(payload)
    payload["evm"]["frames"][0]["frames"][0]["storage"] = [[hex(3), hex(4), 1, 0, hex(2)]]
    assert not _verify(payload)


def test_code_and_account_record_binding(stub_keccak):
    """Frame code and EXTCODESIZE / EXTCODEHASH records bind to the parent
    accounts' code hashes."""
    code = bytes.fromhex("6001600155")  # the executing contract's code
    code2 = bytes.fromhex("30313233343536")  # EXTCODE* target's code
    a2 = int.from_bytes(ADDR2, "big")

    def world(pkg):
        st = pkg.trie.MptNode.null()
        state = pkg.trie.MptNode.null()
        state.insert(pkg.trie.to_nibs(keccak256(ADDR)), pkg.types.Account(
            nonce=1, balance=100, storage_root=st.hash(), code_hash=keccak256(code)).encode())
        state.insert(pkg.trie.to_nibs(keccak256(ADDR2)), pkg.types.Account(
            balance=5, storage_root=pkg.empty_root, code_hash=keccak256(code2)).encode())
        return state, {ADDR: st}, pkg.types.BlockHeader(state_root=state.hash(), number=7)

    frames = [{"address": int.from_bytes(ADDR, "big"), "code": code, "world": {a2: {"code": code2}},
               "acct_ctx": {(2, a2): len(code2), (3, a2): 0}}]
    ps, header = _prove_both(None, lambda pkg: copy.deepcopy(frames), world)
    assert ps is not None and "0x" + ADDR2.hex() in ps["codes"]

    def payload(rec, slot=ps):
        return {"chain": {"state_root": keccak256(header.encode()).hex()},
                "evm": {"frames": [{"frames": [rec]}]}, "prestate": slot}

    ch2 = int.from_bytes(keccak256(code2), "big")
    good = {"env": {"address": "0x" + ADDR.hex()}, "code": code.hex(), "storage": [],
            "acct_ctx": [[2, hex(a2), hex(len(code2))], [3, hex(a2), hex(ch2)]]}
    assert _verify(payload(good))
    assert not _verify(payload(dict(good, code=(code + b"\x00").hex())))  # wrong frame code
    assert not _verify(payload(dict(good, acct_ctx=[[2, hex(a2), hex(len(code2) + 1)]])))  # EXTCODESIZE
    assert not _verify(payload(dict(good, acct_ctx=[[3, hex(a2), hex(ch2 ^ 1)]])))  # EXTCODEHASH
    # EXTCODEHASH of an absent account binds to zero
    missing = b"\xdd" * 20
    m = int.from_bytes(missing, "big")
    frames2 = [{"address": int.from_bytes(ADDR, "big"), "code": code, "acct_ctx": {(3, m): 0}}]
    ps2, _ = _prove_both(None, lambda pkg: copy.deepcopy(frames2), world)
    good2 = {"env": {"address": "0x" + ADDR.hex()}, "code": code.hex(), "storage": [],
             "acct_ctx": [[3, hex(m), hex(0)]]}
    assert _verify(payload(good2, ps2))
    assert not _verify(payload(dict(good2, acct_ctx=[[3, hex(m), hex(5)]]), ps2))


# --- the 10-tx block under the default config against its JAX golden

# The state-trie statement's and the prestate's message order follow the
# reference preflight's set of accessed accounts, so the block is proven
# in a subprocess under the golden's PYTHONHASHSEED
# (tools/make_stark_goldens.py).
_BLOCK_SCRIPT = r"""
import copy, hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(int(sys.argv[4]))
from raiko_tpu_torch.chain import SupportedChainSpecs
from raiko_tpu_torch.core.interfaces import ProofRequest, ProofType
from raiko_tpu_torch.core.orchestrator import Raiko
from raiko_tpu_torch.provers import tpu_stark
from raiko_tpu_torch.testing.workload import build_chain

inp, device = json.loads(sys.argv[2]), sys.argv[3]
sha = lambda o: hashlib.sha256(json.dumps(o, sort_keys=True).encode()).hexdigest()
build_chain(1, inp["txs"], None)
req = ProofRequest(block_number=inp["block_number"], network=inp["network"],
                   proof_type=ProofType.TPU_STARK, prover_args=dict(inp["prover_args"]))
raiko = Raiko(SupportedChainSpecs(), req, device)
gi = raiko.generate_input()
out = raiko.get_output(gi)
proof = raiko.prove(gi, out)
payload = json.loads(proof.proof)
bad = copy.deepcopy(payload)
bad["evm"]["frames"][0]["frames"][0]["gas_f"] -= 1
print(json.dumps({
    "block_hash": gi.block_header.hash().hex(), "instance_hash": out.hash.hex(),
    "input": proof.input_hash, "kzg_proof": proof.kzg_proof, "sha256": sha(payload),
    "statements": {slot: sha(payload[slot]) for slot in sorted(payload)},
    "covered": payload["evm"]["covered"], "total": payload["evm"]["total"],
    "verified": tpu_stark.verify_payload(payload, device),
    "tampered_verified": tpu_stark.verify_payload(bad, device)}))
"""


def _check_block_10tx_evm(device: str, threads: int) -> None:
    import subprocess
    import sys

    g = _golden("block_10tx_evm")
    inp = g["inputs"]
    repo = os.path.dirname(os.path.dirname(GOLDEN))
    run = subprocess.run(
        [sys.executable, "-c", _BLOCK_SCRIPT, repo, json.dumps(inp), device, str(threads)],
        env={**os.environ, "PYTHONHASHSEED": inp["python_hash_seed"]},
        capture_output=True, text=True, timeout=3000,
    )
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["block_hash"] == g["block_hash"], "the block recipe drifted from the golden's"
    assert got["instance_hash"] == g["instance_hash"]
    assert (got["covered"], got["total"]) == (g["evm_covered"], g["evm_total"]) == (9, 9)
    assert "evm" in got["statements"] and "prestate" in got["statements"]
    assert got["statements"] == g["statements"]
    assert got["sha256"] == g["sha256"]
    assert got["input"] == g["input"] and got["kzg_proof"] == g["kzg_proof"]
    assert got["verified"]
    assert not got["tampered_verified"]


@pytest.mark.slow
def test_block_10tx_evm_on_cpu_equals_jax_golden():
    _check_block_10tx_evm("cpu", 4)


@pytest.mark.cuda
def test_block_10tx_evm_on_card_equals_jax_golden():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    _check_block_10tx_evm("cuda", 4)
