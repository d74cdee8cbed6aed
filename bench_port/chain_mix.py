"""The benchmark's traffic recipe: taiko_a7 blob blocks of the bench mix,
drawn from a seed.

The mix is synthetic: the repo's own bench recipe, not a sample of real
Hekla blocks, whose transactions and state are not in the repo.

A copy of ``raiko_tpu_torch/testing/workload.build_chain``'s recipe (80%
storage churn over up to 20 contracts, 10% value transfers, 10% calls
into a contract that CALLs another and the identity precompile), made
seeded: the seed draws the sender keys, the contracts' initial storage
and the order of the transactions' kinds inside each block.  Every seed
gets the same multiset of kinds in every block, the same code and the
same storage paths (every initial slot is non-zero, so each SSTORE takes
the same gas branch), so seeds change the values and the order, not the
work.

The blocks are produced by the port's chain simulator
(``raiko_tpu_torch.testing.chainsim``) and registered with its provider,
where the port's preflight finds them.
"""

from __future__ import annotations

import random

SECP256K1_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
N_SENDERS = 8
CHURN_CODE = bytes.fromhex("6001546001016001556002546001016002" + "5500")
CALLEE_B = bytes([0x60, 0x00, 0x35, 0x60, 0x01, 0x01, 0x60, 0x00, 0x52, 0x60, 0x20, 0x60, 0x00, 0xF3])
ADDR_B = b"\x97" + b"\x00" * 19
ADDR_A = b"\x98" + b"\x00" * 19
CALLER_A = bytes([
    0x60, 41, 0x60, 0x00, 0x52,
    0x60, 0x20, 0x60, 0x20, 0x60, 0x20, 0x60, 0x00, 0x60, 0x00,
    0x73, *ADDR_B, 0x61, 0xFF, 0xFF, 0xF1,
    0x60, 0x20, 0x51, 0x01,
    0x60, 0x20, 0x60, 0x40, 0x60, 0x20, 0x60, 0x00, 0x60, 0x00,
    0x60, 0x04, 0x61, 0xFF, 0xFF, 0xF1,
    0x00,
])
KINDS = ("churn", "transfer", "call")


def block_kinds(rng: random.Random, n_txs: int, mix: dict) -> list[str]:
    """The kinds of one block's `n_txs` transactions: `mix` gives the count
    of each kind in every group of sum(mix) transactions, shuffled."""
    group = sum(mix[k] for k in KINDS)
    if n_txs % group:
        raise ValueError(f"{n_txs} transactions do not split into groups of {group}")
    kinds = [k for k in KINDS for _ in range(mix[k] * (n_txs // group))]
    rng.shuffle(kinds)
    return kinds


def draw(seed: int, n_blocks: int, n_txs: int, mix: dict, n_contracts: int) -> dict:
    """Everything the seed decides: sender keys, initial storage, each
    block's kinds.  Plain data, so a test can see what a seed gives."""
    rng = random.Random(seed)
    keys = [rng.randrange(1, SECP256K1_ORDER) for _ in range(N_SENDERS)]
    storage = [{1: rng.randrange(1, 1 << 32), 2: rng.randrange(1, 1 << 32)} for _ in range(n_contracts)]
    kinds = [block_kinds(rng, n_txs, mix) for _ in range(n_blocks)]
    return {"keys": keys, "storage": storage, "kinds": kinds}


def build_chain(seed: int, n_blocks: int, n_txs: int, mix: dict, n_contracts: int, device, *, l1_network: str):
    """Produce `n_blocks` taiko_a7 blob blocks of `n_txs` transactions each
    (blocks 1..n_blocks) with the port's chain simulator on `device`, over
    a simulated L1 of the chain spec `l1_network`, and register the chains
    with the port's provider.  Returns (the L2 sim, what the seed drew)."""
    from raiko_tpu_torch.core import provider
    from raiko_tpu_torch.proto.types import Transaction
    from raiko_tpu_torch.testing.chainsim import ChainSim, TaikoSim
    from raiko_tpu_torch.utils import secp256k1

    drawn = draw(seed, n_blocks, n_txs, mix, n_contracts)
    keys = drawn["keys"]
    senders = [secp256k1.pubkey_to_address(secp256k1.pubkey(k)) for k in keys]
    provider._SIM_REGISTRY.clear()
    l1 = ChainSim(l1_network, device=device)
    for s in senders:
        l1.fund(s, 10**20)
    l1.produce_block([])
    l2 = TaikoSim(l1, "taiko_a7", device=device)
    for s in senders:
        l2.fund(s, 10**20)
    contracts = []
    for i in range(n_contracts):
        addr = bytes([0x95, i]) + b"\x00" * 18
        l2.fund(addr, 0, code=CHURN_CODE, storage=drawn["storage"][i])
        contracts.append(addr)
    l2.fund(ADDR_B, 0, code=CALLEE_B)
    l2.fund(ADDR_A, 0, code=CALLER_A)
    nonces = [0] * len(keys)

    def mktx(si, to, value=0, gas=200_000):
        tx = Transaction(tx_type=2, chain_id=167009, nonce=nonces[si], max_priority_fee_per_gas=1,
                         max_fee_per_gas=100, gas_limit=gas, to=to, value=value)
        tx.sign(keys[si])
        nonces[si] += 1
        return tx

    for blk, kinds in enumerate(drawn["kinds"]):
        txs, churned = [], 0
        for i, kind in enumerate(kinds):
            si = i % len(keys)
            if kind == "transfer":
                txs.append(mktx(si, bytes([0x66, i % 256, blk % 256]) + b"\x00" * 17, value=7, gas=21_000))
            elif kind == "call":
                txs.append(mktx(si, ADDR_A, gas=150_000))
            else:
                txs.append(mktx(si, contracts[churned % n_contracts]))
                churned += 1
        l2.produce_taiko_block(txs, use_blob=True)
    provider.register_sim(l1_network, l1)
    provider.register_sim("taiko_a7", l2)
    return l2, drawn
