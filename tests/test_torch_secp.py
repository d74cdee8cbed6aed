"""The port's batched secp256k1 sender recovery on the CPU.

Each lane of ``recover_pubkeys_batch`` (the plain Shamir ladder, kernel
B4's CPU version) must equal ``raiko_tpu.utils.secp256k1.recover_pubkey``
exactly, invalid lanes giving None; ``recover_senders`` must keep the
contract of ``raiko_tpu.evm.execute._batch_recover_senders``, which the
port's copy of ``evm/execute.py`` calls it under.  The test
marked ``cuda`` holds the kernel against the plain ladder on a card.
"""

import numpy as np
import pytest
import torch

from raiko_tpu.proto.types import Transaction
from raiko_tpu.utils import secp256k1 as host
from raiko_tpu_torch import convert
from raiko_tpu_torch.evm import execute
from raiko_tpu_torch.ops import secp, secp_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _items(seed: int, k: int):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(k):
        msg = rng.bytes(32)
        r, s, rec = host.sign(msg, int.from_bytes(rng.bytes(31), "big") + 1)
        items.append((msg, r, s, rec))
    return items


def test_recover_pubkeys_batch_matches_host():
    items = _items(1, 15)
    msg, r, s, rec = items[5]
    items[5] = (msg, r, 0, rec)  # s out of range: host check
    msg, r, s, rec = items[9]
    items[9] = (msg, r, s, 7)  # bad recovery id
    items.append((b"\x01" * 32, 5, 7, 0))  # x = 5 is not on the curve
    got = secp.recover_pubkeys_batch(items, CPU)
    want = [host.recover_pubkey(*it) for it in items]
    assert got == want
    assert got[5] is None and got[9] is None and got[-1] is None
    assert all(q is not None for i, q in enumerate(got[:15]) if i not in (5, 9))


def test_recover_pubkeys_batch_all_invalid():
    assert secp.recover_pubkeys_batch([(b"\x00" * 32, 0, 1, 0)] * 3, CPU) == [None] * 3


def _txs(k: int):
    txs = []
    for i in range(k):
        tx = Transaction(tx_type=2, chain_id=167009, nonce=i, max_priority_fee_per_gas=1,
                         max_fee_per_gas=100, gas_limit=21000, to=b"\x88" * 20, value=i)
        txs.append(tx.sign(0xCAFE + i % 3))
    return txs


def test_recover_senders_keeps_the_execute_contract():
    txs = _txs(17)
    txs[3].s = host.N - txs[3].s  # high-s: rejected by signature_parts
    txs[11].r = 5  # R is off the curve: the recovery fails
    slots = secp.recover_senders(txs, CPU)
    assert len(slots) == len(txs)
    for i, (tx, slot) in enumerate(zip(txs, slots)):
        if i in (3, 11):
            assert isinstance(slot, ValueError)
            with pytest.raises(ValueError):
                tx.recover_sender()
        else:
            assert slot == tx.recover_sender()


def test_batch_recover_senders_policy():
    # below the batch threshold, off the card, and with no device, the
    # per-tx host path runs
    assert execute._batch_recover_senders(_txs(15), CPU) is None
    assert execute._batch_recover_senders(_txs(16), CPU) is None
    assert execute._batch_recover_senders(_txs(16), None) is None
    assert secp.use_device_recovery(torch.device("cuda"))
    assert not secp.use_device_recovery(CPU)


@pytest.mark.cuda
def test_shamir_ladder_matches_plain_on_card(cuda_device):
    _, base_np, idx_np = secp.ladder_inputs(_items(2, 40))
    base = convert.pack32(torch.as_tensor(base_np))
    idx = torch.as_tensor(idx_np)
    got = secp_cuda.shamir_ladder(base.to(cuda_device), idx.to(cuda_device))
    assert torch.equal(got.cpu(), secp_cuda.shamir_ladder_plain(base, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [1, 33, 101, 257])
def test_shamir_ladder_edges_match_plain_on_card(cuda_device, bsz):
    # B4 runs one warp per signature; batches that fill no round number of
    # anything, and lanes whose indices are all 0 (the identity throughout),
    # all 1 and all 2
    _, base_np, idx_np = secp.ladder_inputs(_items(3, bsz))
    base = convert.pack32(torch.as_tensor(base_np))
    idx = torch.as_tensor(idx_np)
    if bsz >= 3:
        idx[:, :3] = torch.arange(3, dtype=torch.int32)
    got = secp_cuda.shamir_ladder(base.to(cuda_device), idx.to(cuda_device))
    assert torch.equal(got.cpu(), secp_cuda.shamir_ladder_plain(base, idx))
