"""The plain references agree with the port where the port is sound, and
disagree where it is not."""

import copy
import json
import os

import pytest

import run

P = 2**31 - 2**27 + 1


@pytest.fixture(scope="module")
def tree_proof():
    from raiko_tpu_torch.stark.airs import evm_air as ea

    with open(os.path.join(run.ROOT, "tests", "golden", "stark_evm_call_tree.json")) as f:
        inp = json.load(f)["inputs"]
    ft = ea.execute_frame(bytes.fromhex(inp["caller"]), ea.FrameEnv(**inp["env"]), inp["gas"],
                          world={inp["callee_address"]: {"code": bytes.fromhex(inp["callee"])}},
                          warm_addresses=set())
    return ea.prove_frame_trace(ft, "cpu")


def test_frozen_verifier_accepts_what_the_port_accepts(tree_proof):
    from raiko_tpu_torch.stark.airs import evm_air as ea

    from trees import reference_accepts

    evm = {"kind": "evm-frames-v1", "total": 1, "covered": 1, "frames": [tree_proof]}
    assert ea.verify_frame_payload(tree_proof, "cpu")
    assert reference_accepts(evm)


@pytest.mark.parametrize("fault", ["opened value", "fewer tables", "covered count"])
def test_frozen_verifier_rejects(tree_proof, fault):
    from trees import reference_accepts

    tree = copy.deepcopy(tree_proof)
    evm = {"kind": "evm-frames-v1", "total": 1, "covered": 1, "frames": [tree]}
    if fault == "opened value":
        tree["starks"][-1]["queries"][3]["quot_row"][0] = (tree["starks"][-1]["queries"][3]["quot_row"][0] + 1) % P
    elif fault == "fewer tables":
        tree["starks"] = tree["starks"][:-1]
    else:
        evm["covered"] = 2
    assert not reference_accepts(evm)


def test_native_reference_equals_the_port():
    from raiko_tpu_torch.chain import SupportedChainSpecs
    from raiko_tpu_torch.core.interfaces import ProofRequest, ProofType
    from raiko_tpu_torch.core.orchestrator import Raiko
    from raiko_tpu_torch.kzg import eip4844

    import native_reference as ref

    unit_mod = run.load_module(os.path.join(run.HERE, "units", "native_request.py"), "t_native")
    from chain_mix import build_chain

    l2, _ = build_chain(11, 2, 10, {"churn": 8, "transfer": 1, "call": 1}, 2, "cpu", l1_network="holesky")
    unit = unit_mod.Unit.__new__(unit_mod.Unit)
    unit.l2, unit.l1 = l2, l2.l1
    setup = ref.load_setup()
    for blk, kind in ((1, "proof_of_commitment"), (2, "proof_of_equivalence")):
        prover, graffiti = "0x" + "5a" * 20, "0x" + f"{blk:064x}"
        req = ProofRequest(block_number=blk, network="taiko_a7", l1_network="holesky", proof_type=ProofType.NATIVE,
                           prover=prover, graffiti=graffiti, blob_proof_type=kind)
        raiko = Raiko(SupportedChainSpecs(), req, "cpu")
        gi = raiko.generate_input()
        want = raiko.get_output(gi).hash
        d = unit.block_data(blk)
        poe = (0, 0) if kind == "proof_of_commitment" else ref.proof_of_equivalence(d["blob"], d["versioned_hash"], setup)
        got = ref.instance_hash(167009, bytes(20), d["parent_hash"], d["block_hash"], d["state_root"],
                                bytes.fromhex(graffiti[2:]), bytes.fromhex(prover[2:]), d["event"], poe)
        assert got == want
        other = ref.instance_hash(167009, bytes(20), d["parent_hash"], d["block_hash"], d["state_root"],
                                  bytes(32), bytes.fromhex(prover[2:]), d["event"], poe)
        assert other != want
    d = unit.block_data(1)
    assert ref.kzg_proof(d["blob"], d["versioned_hash"], setup) == eip4844.calc_kzg_proof(d["blob"], d["versioned_hash"], None)


def test_trusted_setup_holds_to_published_values():
    import numpy as np

    from raiko_tpu_torch.kzg import host_curve

    import native_reference as ref

    assert ref.G1_GENERATOR == host_curve.G1_GEN
    with np.load(ref.SETUP) as z:
        roots = [int.from_bytes(bytes(r), "big") for r in z["roots_natural"]]
    assert roots == ref.roots_of_unity()  # the table's roots are the spec's
    setup = ref.load_setup()
    assert ref.setup_faults(setup) == 0
    g1 = list(setup[0])
    g1[7] = ref.g1_add(g1[7], ref.G1_GENERATOR)  # one point altered, still on the curve
    assert ref.setup_faults((g1, setup[1])) == 1
