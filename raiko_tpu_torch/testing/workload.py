"""The bench block workload of the port's chain simulator.

``build_chain`` produces taiko_a7 blob blocks of ``tools/bench_block.py``'s
mix and registers the chains with the port's provider; ``chip_smoke.py``
serves and proves them, and the port's tests prove the small ones.
``tools/make_stark_goldens.py`` builds the same block with the JAX
package's simulator from a copy of this recipe, and its golden keeps the
block's hash, so a recipe that drifts shows before any proof is compared.
"""

from __future__ import annotations


def build_chain(n_blocks: int, n_txs: int, device):
    """The 100-tx taiko_a7 blob-block workload of tools/bench_block.py
    (80% storage churn over 20 contracts, 10% transfers, 10% calls into a
    contract that CALLs another and the identity precompile), n_blocks
    times, registered with the port's provider; block production runs its
    device work on `device`.  Returns the L2 sim."""
    from ..core import provider
    from ..proto.types import Transaction
    from ..utils import secp256k1
    from .chainsim import ChainSim, TaikoSim

    keys = [0xBE7C + i for i in range(8)]
    senders = [secp256k1.pubkey_to_address(secp256k1.pubkey(k)) for k in keys]
    provider._SIM_REGISTRY.clear()
    l1 = ChainSim("ethereum", device=device)
    for s in senders:
        l1.fund(s, 10**20)
    l1.produce_block([])
    l2 = TaikoSim(l1, "taiko_a7", device=device)
    for s in senders:
        l2.fund(s, 10**20)
    n_contracts = max(1, min(20, n_txs // 5))
    churn_code = bytes.fromhex("6001546001016001556002546001016002" + "5500")
    contracts = []
    for i in range(n_contracts):
        addr = bytes([0x95, i]) + b"\x00" * 18
        l2.fund(addr, 0, code=churn_code, storage={1: 5 + i, 2: 9 + i})
        contracts.append(addr)
    callee_b = bytes([0x60, 0x00, 0x35, 0x60, 0x01, 0x01, 0x60, 0x00, 0x52, 0x60, 0x20, 0x60, 0x00, 0xF3])
    addr_b = b"\x97" + b"\x00" * 19
    l2.fund(addr_b, 0, code=callee_b)
    caller_a = bytes([
        0x60, 41, 0x60, 0x00, 0x52,
        0x60, 0x20, 0x60, 0x20, 0x60, 0x20, 0x60, 0x00, 0x60, 0x00,
        0x73, *addr_b, 0x61, 0xFF, 0xFF, 0xF1,
        0x60, 0x20, 0x51, 0x01,
        0x60, 0x20, 0x60, 0x40, 0x60, 0x20, 0x60, 0x00, 0x60, 0x00,
        0x60, 0x04, 0x61, 0xFF, 0xFF, 0xF1,
        0x00,
    ])
    addr_a = b"\x98" + b"\x00" * 19
    l2.fund(addr_a, 0, code=caller_a)
    nonces = [0] * len(keys)

    def mktx(si, to, value=0, gas=200_000):
        tx = Transaction(tx_type=2, chain_id=167009, nonce=nonces[si], max_priority_fee_per_gas=1,
                         max_fee_per_gas=100, gas_limit=gas, to=to, value=value)
        tx.sign(keys[si])
        nonces[si] += 1
        return tx

    for blk in range(n_blocks):
        txs = []
        for i in range(n_txs):
            si = i % len(keys)
            if i % 10 == 8:
                txs.append(mktx(si, bytes([0x66, i]) + bytes([blk]) + b"\x00" * 17, value=7, gas=21_000))
            elif i % 10 == 9:
                txs.append(mktx(si, addr_a, gas=150_000))
            else:
                txs.append(mktx(si, contracts[i % n_contracts]))
        l2.produce_taiko_block(txs, use_blob=True)
    provider.register_sim("ethereum", l1)
    provider.register_sim("taiko_a7", l2)
    return l2
