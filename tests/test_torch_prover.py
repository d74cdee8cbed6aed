"""The port's STARK prover and verifier on the CPU, against the JAX package.

The extension-field ops and the FRI fold take numpy-seeded inputs through
raiko_tpu (JAX on the CPU) and raiko_tpu_torch.  Whole proofs are compared
as ``json.dumps(proof_to_dict(p), sort_keys=True)``, byte for byte (field
arithmetic and the Fiat-Shamir transcript are exact, so the tolerance is
0): the fib AIR against a live JAX proof, and the Poseidon2 transcript AIR,
the permutation AIR (aux segment), an AIR with a committed fixed segment
and a small keccak batch against the goldens that
``tools/make_stark_goldens.py`` wrote with the JAX package.  Every port
proof must also pass ``raiko_tpu.stark.verifier.verify_tables`` and the
port's own verifier; a tampered proof must fail the port's.  The tests
marked ``cuda`` prove the same goldens on a card.
"""

import copy
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raiko_tpu.fields import babybear as jbb
from raiko_tpu.fields import babybear_ext as jef
from raiko_tpu.stark import fri as jfri
from raiko_tpu.stark import prover as jprover
from raiko_tpu.stark import serde as jserde
from raiko_tpu.stark import verifier as jverifier
from raiko_tpu.stark.airs.fib import FibAir as JFibAir
from raiko_tpu.stark.airs.keccak_air import KeccakBatchSpongeAir as JKeccakBatchSpongeAir
from raiko_tpu.stark.airs.permcheck import PermutationAir as JPermutationAir
from raiko_tpu.stark.airs.poseidon2_air import Poseidon2TranscriptAir as JPoseidon2TranscriptAir
from raiko_tpu_torch import convert
from raiko_tpu_torch.fields import babybear as bb
from raiko_tpu_torch.fields import babybear_ext as ef
from raiko_tpu_torch.stark import fri, prover, serde, verifier
from raiko_tpu_torch.stark.air import Air, ConstraintBuilder
from raiko_tpu_torch.stark.airs.fib import FibAir
from raiko_tpu_torch.stark.airs.keccak_air import KeccakBatchSpongeAir
from raiko_tpu_torch.stark.airs.permcheck import PermutationAir
from raiko_tpu_torch.stark.airs.poseidon2_air import Poseidon2TranscriptAir

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _canon(proof) -> str:
    return json.dumps(serde.proof_to_dict(proof), sort_keys=True)


def _as_jax(proof) -> jprover.StarkProof:
    return jserde.proof_from_dict(json.loads(_canon(proof)))


def _golden(case: str) -> dict:
    with open(os.path.join(GOLDEN, f"stark_{case}.json")) as f:
        return json.load(f)


# --- the AIR with a committed fixed segment (tests/test_committed_fixed.py)


def _affine_fixed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = rng.integers(0, bb.P, size=(2, n), dtype=np.uint64).astype(np.uint32)
    f[1] = np.maximum(f[1], 1)  # multiplicative column nonzero
    return f


class AffineChainAir(Air):
    """t' = t * f1 + f0 with committed fixed columns f0, f1."""

    width = 1
    commit_fixed = True

    def __init__(self, fixed_seed: int):
        self.fixed_seed = fixed_seed

    def eval(self, b: ConstraintBuilder) -> None:
        t0, t1 = b.local(0), b.next(0)
        f0, f1 = b.fixed(0), b.fixed(1)
        b.transition(b.sub(t1, b.add(b.mul(t0, f1), f0)))
        b.first_row(b.sub(t0, b.public(0)))
        b.last_row(b.sub(t0, b.public(1)))

    def fixed_columns(self, n: int):
        return _affine_fixed(n, self.fixed_seed)

    def trace(self, log_n: int, start: int):
        n = 1 << log_n
        f = self.fixed_columns(n)
        rows = np.zeros((n, 1), dtype=np.uint32)
        t = start % bb.P
        for i in range(n):
            rows[i, 0] = t
            t = (t * int(f[1, i]) + int(f[0, i])) % bb.P
        return rows, [start % bb.P, int(rows[n - 1, 0])]


def _case(name: str):
    """(port AIR, JAX AIR for raiko_tpu's verifier, trace, publics, golden)
    of a golden case, built from the golden's inputs."""
    g = _golden(name)
    inp = g["inputs"]
    if name == "fib":
        trace, publics = FibAir.trace(inp["log_n"], inp["a"], inp["b"])
        return FibAir(), JFibAir(), trace, publics, g
    if name == "transcript":
        air = Poseidon2TranscriptAir(inp["blocks"])
        return air, JPoseidon2TranscriptAir(inp["blocks"]), air.trace(), g["publics"], g
    if name == "permcheck":
        trace = PermutationAir.make_trace(inp["a"], inp["b"])
        return PermutationAir(), JPermutationAir(), trace, [], g
    if name == "affine":
        air = AffineChainAir(inp["fixed_seed"])
        trace, publics = air.trace(inp["log_n"], inp["start"])
        return air, air, trace, publics, g
    msgs = [bytes.fromhex(m) for m in inp["messages"]]
    air = KeccakBatchSpongeAir(msgs)
    return air, JKeccakBatchSpongeAir(msgs), air.trace(), air.publics(), g


def _check_against_golden(name: str, device):
    air, jair, trace, publics, g = _case(name)
    assert list(trace.shape) == g["trace_shape"] and publics == g["publics"]
    proof = prover.prove(air, trace, publics, device=device)
    d = serde.proof_to_dict(proof)
    roots = {"trace_root": d["trace_root"], "aux_root": d["aux_root"], "fixed_root": d["fixed_root"],
             "quotient_root": d["quotient_root"], "fri_layer_roots": d["fri"]["layer_roots"]}
    assert roots == g["roots"]  # the first commitment that differs
    if "proof" in g:
        assert d == g["proof"]
    assert hashlib.sha256(_canon(proof).encode()).hexdigest() == g["sha256"]
    assert verifier.verify(air, proof, device=device)
    assert jverifier.verify_tables([jair], [_as_jax(proof)])
    return proof


# --- the extension field and the FRI fold against JAX --------------------


def _ef(seed: int, shape) -> np.ndarray:
    return jbb.np_to_mont(np.random.default_rng(seed).integers(0, jbb.P, shape + (4,), dtype=np.uint32))


def _t(a: np.ndarray) -> torch.Tensor:
    return convert.words_from_numpy(a, "cpu")


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "mul_base", "from_base", "pow"])
def test_ef_ops_match_jax(op):
    a, b = _ef(1, (512,)), _ef(2, (512,))
    a[:2] = [[0, 0, 0, 0], [jbb.P - 1] * 4]
    b[:2] = [[jbb.P - 1] * 4, [0, 0, 0, 0]]
    x = a[:, 0]
    got, want = {
        "add": (lambda: ef.ef_add(_t(a), _t(b)), lambda: jef.ef_add(a, b)),
        "sub": (lambda: ef.ef_sub(_t(a), _t(b)), lambda: jef.ef_sub(a, b)),
        "neg": (lambda: ef.ef_neg(_t(a)), lambda: jef.ef_neg(a)),
        "mul": (lambda: ef.ef_mul(_t(a), _t(b)), lambda: jef.ef_mul(jnp.asarray(a), jnp.asarray(b))),
        "mul_base": (lambda: ef.ef_mul_base(_t(a), _t(x)), lambda: jef.ef_mul_base(a, jnp.asarray(x))),
        "from_base": (lambda: ef.ef_from_base(_t(x)), lambda: jef.ef_from_base(jnp.asarray(x))),
        "pow": (lambda: ef.ef_pow(_t(a[:64]), 1000003), lambda: jef.ef_pow(jnp.asarray(a[:64]), 1000003)),
    }[op]
    np.testing.assert_array_equal(convert.bb_to_numpy(got()), np.asarray(want()))


def test_ef_broadcast_and_host_transfer_match_jax():
    a, b = _ef(3, (8, 16)), _ef(4, (16,))
    got = ef.ef_mul(_t(a), _t(b)[None])
    np.testing.assert_array_equal(convert.bb_to_numpy(got), np.asarray(jef.ef_mul(a, b[None])))
    vals = [tuple(int(v) for v in row) for row in jbb.np_from_mont(a.reshape(-1, 4))]
    np.testing.assert_array_equal(convert.bb_to_numpy(ef.to_device(vals, "cpu")), np.asarray(jef.to_device(vals)))
    assert ef.from_device(ef.to_device(vals, "cpu")) == jef.from_device(jef.to_device(vals)) == vals
    assert ef.from_device(ef.ef_one((3,), "cpu")) == [ef.H_ONE] * 3


def test_fold_layer_matches_jax():
    log_m = 8
    values = _ef(5, (1 << log_m,))
    beta = _ef(6, ())
    inv2x = fri._inv2x_table(log_m, bb.GENERATOR)
    np.testing.assert_array_equal(inv2x, jfri._inv2x_table(log_m, jbb.GENERATOR))
    got = fri.fold_layer(_t(values), _t(inv2x), _t(beta))
    want = jfri.fold_layer(jnp.asarray(values), jnp.asarray(inv2x), jnp.asarray(beta))
    np.testing.assert_array_equal(convert.bb_to_numpy(got), np.asarray(want))


# --- the prover's algebra and device helpers against JAX -----------------

_W, _M, _AUX_W = 6, 64, 8


def _algebras():
    """The port's and the reference's _ProverAlgebra over the same seeded
    LDEs, next-row permutation, publics, challenges and bus values."""
    rng = np.random.default_rng(7)

    def mont(shape):
        return jbb.np_to_mont(rng.integers(0, jbb.P, shape, dtype=np.uint32))

    lde, fixed, aux = mont((_W, _M)), mont((3, _M)), mont((_AUX_W, _M))
    publics, chal, bus = mont((5,)), mont((8,)), mont((4,))
    nxt = rng.permutation(_M).astype(np.int32)
    t = lambda a: convert.words_from_numpy(a, "cpu").long()  # noqa: E731
    port = prover._ProverAlgebra(t(lde), torch.as_tensor(nxt.astype(np.int64)), t(publics), t(fixed), t(aux),
                                 t(chal), t(bus))
    ref = jprover._ProverAlgebra(jnp.asarray(lde), nxt, jnp.asarray(publics), jnp.asarray(fixed),
                                 jnp.asarray(aux), jnp.asarray(chal), jnp.asarray(bus))
    return port, ref


_ALGEBRA_CASES = {
    "local_next": lambda a: a.add(a.local(1), a.mul(a.next(2), a.scale(5, a.local(0)))),
    "fixed_aux": lambda a: a.sub(a.mul(a.fixed(2), a.aux(3)), a.aux_next(7)),
    "scalars": lambda a: a.add(a.mul(a.local(0), a.challenge_coord(5)),
                               a.sub(a.bus_coord(2), a.add(a.public(4), a.constant(123456789)))),
    "blocks": lambda a: a.mul(a.sub(a.local_block([0, 3, 5]), a.next_block([1, 1, 4])),
                              a.add(a.fixed_block([2, 0, 1]), a.aux_block([6, 0, 2]))),
    "aux_next_public_block": lambda a: a.sub(a.aux_next_block([1, 5]), a.public_block([0, 3])),
    "stack_linmap": lambda a: a.linmap([[1, 2, 0], [0, jbb.P - 1, 3], [7, 7, 7], [0, 0, 0]],
                                       a.stack([a.local(0), a.next(1), a.fixed(2)])),
    "const_vec_rowsum": lambda a: a.block_rowsum(a.mul(a.local_block([0, 1, 2]), a.const_vec([3, jbb.P - 2, 11]))),
    "concat_rows": lambda a: a.concat_rows([a.local_block([4, 5]), a.aux(1), a.fixed_block([0])]),
    "bit_block_code": lambda a: a.stack(a.bit_block_code(  # 8 bit rows: one byte
        a.concat_rows([a.local_block(range(_W)), a.aux_block(range(2))]),
        [a.challenge_coord(k) for k in range(4)], a.local(2), 1)),
}


@pytest.mark.parametrize("case", sorted(_ALGEBRA_CASES))
def test_prover_algebra_matches_jax(case):
    port, ref = _algebras()
    got = _ALGEBRA_CASES[case](port)
    want = _ALGEBRA_CASES[case](ref)
    np.testing.assert_array_equal(convert.bb_to_numpy(got), np.asarray(want))


def test_ood_and_deep_helpers_match_jax():
    rng = np.random.default_rng(8)
    z = tuple(int(v) for v in rng.integers(0, jbb.P, 4))
    coeffs = jbb.np_to_mont(rng.integers(0, jbb.P, (5, 32), dtype=np.uint32))
    xs = jbb.np_to_mont(rng.integers(0, jbb.P, 64, dtype=np.uint32))
    zp = prover._ef_powers_device(z, 32, "cpu")
    np.testing.assert_array_equal(convert.bb_to_numpy(zp), np.asarray(jprover._ef_powers_device(z, 32)))
    np.testing.assert_array_equal(convert.bb_to_numpy(prover._ef_dot(_t(coeffs), zp)),
                                  np.asarray(jprover._ef_dot(jnp.asarray(coeffs), jprover._ef_powers_device(z, 32))))
    nb, cdev = prover._inv_linear_consts(z, "cpu")
    got = prover._inv_linear_dev(_t(xs).long(), nb, cdev)
    np.testing.assert_array_equal(convert.bb_to_numpy(got), np.asarray(jprover._ef_inv_linear(jnp.asarray(xs), z)))


# --- whole proofs ---------------------------------------------------------


@pytest.mark.parametrize("log_n", [3])  # m = 32: a proof with no FRI layer
def test_fib_proof_matches_live_jax(log_n):
    trace, publics = FibAir.trace(log_n)
    want = json.dumps(jserde.proof_to_dict(jprover.prove(JFibAir(), trace, publics)), sort_keys=True)
    proof = prover.prove(FibAir(), trace, publics, device="cpu")
    assert _canon(proof) == want
    assert verifier.verify(FibAir(), proof, device="cpu")
    assert jverifier.verify_tables([JFibAir()], [_as_jax(proof)])


@pytest.mark.parametrize("case", ["fib", "transcript", "permcheck", "affine"])
def test_proof_matches_golden(case):
    _check_against_golden(case, "cpu")


@pytest.mark.slow
def test_keccak_batch_proof_matches_golden():
    """3 messages, 4 sponge permutations: the full 4,160-column keccak AIR
    with its 3,461 fixed columns at n = 256 (about 40 s on one CPU thread,
    beyond the Tier-1 budget of this file; the full chunk is proven on the
    card by chip_smoke.py)."""
    proof = _check_against_golden("keccak_small", "cpu")
    assert proof.width == 4160 and len(proof.quotient_at_zeta) == 16


def _tamper(d: dict, what: str) -> None:
    if what == "trace_at_zeta":
        d["trace_at_zeta"][0][0] = (d["trace_at_zeta"][0][0] + 1) % bb.P
    elif what == "quot_row":
        d["queries"][3]["quot_row"][0] = (d["queries"][3]["quot_row"][0] + 1) % bb.P
    elif what == "fri_final":
        d["fri"]["final_values"][0][1] = (d["fri"]["final_values"][0][1] + 1) % bb.P
    elif what == "pow_nonce":
        d["pow_nonce"] += 1
    elif what == "publics":
        d["publics"][2] = (d["publics"][2] + 1) % bb.P


@pytest.fixture(scope="module")
def fib_proof():
    trace, publics = FibAir.trace(5)
    proof = prover.prove(FibAir(), trace, publics, device="cpu")
    assert verifier.verify(FibAir(), proof, device="cpu")
    return proof


@pytest.mark.parametrize("what", ["trace_at_zeta", "quot_row", "fri_final", "pow_nonce", "publics"])
def test_tampered_proof_is_rejected(fib_proof, what):
    d = copy.deepcopy(serde.proof_to_dict(fib_proof))
    _tamper(d, what)
    assert not verifier.verify(FibAir(), serde.proof_from_dict(d), device="cpu")


# --- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fib", "transcript", "permcheck", "affine", "keccak_small", "keccak_chunk"])
def test_cuda_proof_matches_golden(cuda_device, case):
    _check_against_golden(case, cuda_device)
