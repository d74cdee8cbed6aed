"""In-memory chain simulator for integration tests and the smoke run.

The port's own copy of the repository's test chain simulator, built on the
port's modules.  ``device`` (a torch device, or None for the host; no default) is
where block production recovers senders and commits blobs.

Plays the role of the live RPC endpoints the reference's integration tests
depend on (SURVEY.md §4: "integration tests hit live public RPCs") —
producing blocks with real execution, maintaining full state/storage tries,
and serving provider-style queries (blocks, accounts, storage, EIP-1186
proofs) for preflight tests.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

from ..chain import SupportedChainSpecs
from ..evm.builder import _envelope, _index_trie, _withdrawals_root
from ..evm.execute import (
    apply_withdrawals,
    execute_block_txs,
    finalize_state_root,
)
from ..evm.interpreter import BlockEnv
from ..evm.state import AccountInfo, MemDb, StateJournal
from ..mpt import EMPTY_ROOT, MptNode, to_nibs
from ..proto import rlp
from ..proto.input import _trie_from_obj, _trie_to_obj
from ..proto.types import Account, BlockHeader, KECCAK_EMPTY
from ..utils import keccak256


def _clone(trie: MptNode) -> MptNode:
    return _trie_from_obj(_trie_to_obj(trie))


@dataclass
class _Snapshot:
    state_trie: MptNode
    storage_tries: dict
    accounts: dict  # addr -> AccountInfo
    storages: dict  # addr -> {slot: value}


class ChainSim:
    def __init__(self, network: str = "ethereum", base_fee: int = 7, *, device):
        self.spec = SupportedChainSpecs().get(network)
        self.base_fee = base_fee
        self.device = device
        self.accounts: dict[bytes, AccountInfo] = {}
        self.storages: dict[bytes, dict[int, int]] = {}
        self.state_trie = MptNode.null()
        self.storage_tries: dict[bytes, MptNode] = {}
        self.codes: dict[bytes, bytes] = {}
        genesis = BlockHeader(
            number=0,
            gas_limit=30_000_000,
            timestamp=1_700_000_000,
            state_root=self.state_trie.hash(),
            transactions_root=EMPTY_ROOT,
            receipts_root=EMPTY_ROOT,
            base_fee_per_gas=base_fee,
            withdrawals_root=EMPTY_ROOT,
        )
        self.headers: list[BlockHeader] = [genesis]
        self.blocks_txs: list[list] = [[]]
        self.blocks_withdrawals: list[list] = [[]]
        self.snapshots: list[_Snapshot] = [self._snap()]
        self.block_logs: dict[int, list] = {}  # number -> wire-shaped logs
        self.txs_by_hash: dict[bytes, object] = {}
        self.blob_sidecars: dict[int, list] = {}  # beacon slot -> sidecars

    # -- state setup ---------------------------------------------------
    def fund(
        self,
        addr: bytes,
        balance: int,
        nonce: int = 0,
        code: bytes = b"",
        storage: dict | None = None,
    ):
        self.accounts[addr] = AccountInfo(
            nonce=nonce, balance=balance, code=code, exists=True
        )
        self.storages.setdefault(addr, {}).update(storage or {})
        if code:
            self.codes[keccak256(code)] = code
        self._rebuild_tries()
        self.headers[0].state_root = self.state_trie.hash()
        self.snapshots[0] = self._snap()

    def _rebuild_tries(self):
        self.state_trie = MptNode.null()
        self.storage_tries = {}
        for addr, info in self.accounts.items():
            st = MptNode.null()
            for slot, val in self.storages.get(addr, {}).items():
                if val:
                    st.insert(
                        to_nibs(keccak256(slot.to_bytes(32, "big"))), rlp.encode(val)
                    )
            self.storage_tries[addr] = st
            self.state_trie.insert(
                to_nibs(keccak256(addr)),
                Account(
                    nonce=info.nonce,
                    balance=info.balance,
                    storage_root=st.hash(),
                    code_hash=keccak256(info.code) if info.code else KECCAK_EMPTY,
                ).encode(),
            )

    def _snap(self) -> _Snapshot:
        return _Snapshot(
            state_trie=_clone(self.state_trie),
            storage_tries={a: _clone(t) for a, t in self.storage_tries.items()},
            accounts={
                a: AccountInfo(i.nonce, i.balance, i.code, i.exists)
                for a, i in self.accounts.items()
            },
            storages={a: dict(s) for a, s in self.storages.items()},
        )

    # -- block production ----------------------------------------------
    def produce_block(
        self,
        txs,
        withdrawals=None,
        coinbase=b"\xc0" * 20,
        is_taiko=False,
        treasury=None,
        gas_limit=None,
    ):
        withdrawals = withdrawals or []
        parent = self.headers[-1]
        from ..evm.execute import next_base_fee

        base_fee = (
            self.base_fee
            if is_taiko
            else next_base_fee(parent, self.spec.eip_1559_constants)
        )
        db = MemDb()
        for addr, info in self.accounts.items():
            db.insert_account(
                addr,
                AccountInfo(info.nonce, info.balance, info.code, info.exists),
                dict(self.storages.get(addr, {})),
            )
        for h in self.headers[-256:]:
            db.block_hashes[h.number] = h.hash()
        env = BlockEnv(
            number=parent.number + 1,
            timestamp=parent.timestamp + 12,
            gas_limit=gas_limit or parent.gas_limit,
            base_fee=base_fee,
            coinbase=coinbase,
            chain_id=self.spec.chain_id,
        )
        state = StateJournal(db)
        result = execute_block_txs(
            state, env, txs, is_taiko=is_taiko, treasury=treasury, device=self.device
        )
        apply_withdrawals(state, withdrawals)
        root = finalize_state_root(state, self.state_trie, self.storage_tries)
        header = BlockHeader(
            parent_hash=parent.hash(),
            beneficiary=coinbase,
            state_root=root,
            transactions_root=_index_trie([_envelope(tx) for tx in txs]).hash(),
            receipts_root=_index_trie([r.encode() for r in result.receipts]).hash(),
            logs_bloom=result.logs_bloom,
            number=env.number,
            gas_limit=env.gas_limit,
            gas_used=result.gas_used,
            timestamp=env.timestamp,
            base_fee_per_gas=base_fee,
            withdrawals_root=_withdrawals_root(withdrawals),
        )
        # apply execution results to the flat world
        for addr in state.all_touched | state.all_selfdestructed:
            acc = state.accounts.get(addr)
            if acc is None:
                continue
            if not acc.exists or (
                acc.nonce == 0 and acc.balance == 0 and not acc.code
            ):
                self.accounts.pop(addr, None)
                self.storages.pop(addr, None)
                continue
            self.accounts[addr] = AccountInfo(
                acc.nonce, acc.balance, acc.code, True
            )
            if acc.code:
                self.codes[keccak256(acc.code)] = acc.code
            slots = self.storages.setdefault(addr, {})
            for (a, slot), val in state.storage.items():
                if a == addr:
                    if val:
                        slots[slot] = val
                    else:
                        slots.pop(slot, None)
        self.headers.append(header)
        self.blocks_txs.append(list(txs))
        self.blocks_withdrawals.append(list(withdrawals))
        self.snapshots.append(self._snap())
        return header

    # -- data-availability blocks (txs carried, not executed) -----------
    def add_da_block(self, txs, logs=None):
        """Append a block that CARRIES transactions and logs without
        executing them (state unchanged) — how the sim hosts L1 proposal
        transactions; raiko never re-executes L1 blocks, it only reads
        their headers, logs and tx data."""
        parent = self.headers[-1]
        header = BlockHeader(
            parent_hash=parent.hash(),
            state_root=parent.state_root,
            transactions_root=_index_trie([_envelope(tx) for tx in txs]).hash(),
            receipts_root=EMPTY_ROOT,
            number=parent.number + 1,
            gas_limit=parent.gas_limit,
            timestamp=parent.timestamp + 12,
            base_fee_per_gas=parent.base_fee_per_gas,
            withdrawals_root=EMPTY_ROOT,
        )
        self.headers.append(header)
        self.blocks_txs.append(list(txs))
        self.blocks_withdrawals.append([])
        self.snapshots.append(self._snap())
        self.block_logs[header.number] = list(logs or [])
        for tx in txs:
            self.txs_by_hash[tx.hash()] = tx
        return header

    # -- provider-style queries ------------------------------------------
    def get_block(self, number: int):
        return self.headers[number], self.blocks_txs[number], self.blocks_withdrawals[number]

    def get_logs_by_block_hash(self, address: bytes, topic0: bytes, block_hash: bytes):
        for h in self.headers:
            if h.hash() == block_hash:
                return [
                    log
                    for log in self.block_logs.get(h.number, [])
                    if bytes.fromhex(log["address"][2:]) == address
                    and bytes.fromhex(log["topics"][0][2:]) == topic0
                ]
        return []

    def get_transaction_by_hash(self, tx_hash: bytes):
        return self.txs_by_hash.get(tx_hash)

    def get_blob_sidecars(self, slot: int):
        """Beacon-API-shaped sidecar list for a slot."""
        return self.blob_sidecars.get(slot, [])

    def tip(self) -> int:
        return len(self.headers) - 1

    def get_account(self, number: int, addr: bytes):
        snap = self.snapshots[number]
        return snap.accounts.get(addr)

    def get_storage(self, number: int, addr: bytes, slot: int) -> int:
        return self.snapshots[number].storages.get(addr, {}).get(slot, 0)

    def get_code(self, number: int, addr: bytes) -> bytes:
        info = self.snapshots[number].accounts.get(addr)
        return info.code if info else b""

    def get_proof(self, number: int, addr: bytes, slots: list[int]):
        """EIP-1186-style proof response."""
        snap = self.snapshots[number]
        account_proof = snap.state_trie.proof(to_nibs(keccak256(addr)))
        st = snap.storage_tries.get(addr, MptNode.null())
        storage_proof = {}
        for slot in slots:
            key = slot.to_bytes(32, "big")
            try:
                storage_proof[key] = st.proof(to_nibs(keccak256(key)))
            except Exception:
                storage_proof[key] = []
        info = snap.accounts.get(addr)
        return {
            "account_proof": account_proof,
            "storage_root": st.hash(),
            "storage_proofs": storage_proof,
            "nonce": info.nonce if info else 0,
            "balance": info.balance if info else 0,
            "code_hash": keccak256(info.code)
            if info and info.code
            else KECCAK_EMPTY,
        }

# --------------------------------------------------------------------------
# Taiko L2 simulation: anchor txs, proposals, blob tx-lists
# --------------------------------------------------------------------------

GOLDEN_TOUCH_KEY = 0x92954368AFD3CAA1F3CE3EAD0069C1AF414054AEFE1EF9AEACC1BF426222CE38


class TaikoSim(ChainSim):
    """A taiko L2 chain paired with an L1 ChainSim.

    Proposals are posted the way they are on chain: a ``proposeBlock``
    transaction in the NEXT L1 block after the anchored state block,
    emitting a ``BlockProposed`` log; blob-DA tx lists become beacon
    sidecars at the inclusion block's slot.  Preflight then discovers
    everything through the wire-shaped provider surface (logs by block
    hash, tx by hash, sidecars by slot) — no side channel."""

    def __init__(self, l1_sim: ChainSim, network: str = "taiko_a7", *, device):
        super().__init__(network, device=device)
        self.l1 = l1_sim
        self.treasury = bytes.fromhex(self.spec.l2_contract[2:].zfill(40))
        self.l1_contract = bytes.fromhex(self.spec.l1_contract[2:].zfill(40))

    def produce_taiko_block(self, txs, use_blob=True, coinbase=b"\xc2" * 20):
        from ..core import l1_data
        from ..evm.execute import ANCHOR_GAS_LIMIT, GOLDEN_TOUCH
        from ..kzg import eip4844
        from ..proto.instance import BlockMetadata
        from ..proto.types import Transaction
        from ..utils.txlist import (
            encode_blob_data,
            encode_transactions,
            zlib_compress_data,
        )
        from ..proto import abi as abimod
        from ..proto.instance import ETH_DEPOSIT_SPEC

        # tx data exactly as posted on chain
        compressed = zlib_compress_data(encode_transactions(txs))
        tx_data = encode_blob_data(compressed) if use_blob else compressed
        # anchor tx: binds the L1 state block (the current L1 tip); the
        # proposal will land in the next L1 block
        l1_state_number = self.l1.tip()
        l1_header = self.l1.headers[l1_state_number]
        parent_l2 = self.headers[-1]
        golden_nonce = self.accounts.get(GOLDEN_TOUCH)
        anchor = Transaction(
            tx_type=2,
            chain_id=self.spec.chain_id,
            nonce=golden_nonce.nonce if golden_nonce else 0,
            max_priority_fee_per_gas=0,
            max_fee_per_gas=self.base_fee,
            gas_limit=ANCHOR_GAS_LIMIT,
            to=self.treasury,
            value=0,
            data=l1_data.encode_anchor(
                l1_data.AnchorCall(
                    l1_hash=l1_header.hash(),
                    l1_state_root=l1_header.state_root,
                    l1_block_id=l1_state_number,
                    parent_gas_used=parent_l2.gas_used,
                )
            ),
        )
        anchor.sign(GOLDEN_TOUCH_KEY)
        all_txs = [anchor] + list(txs)
        header = self.produce_block(
            all_txs,
            coinbase=coinbase,
            is_taiko=True,
            treasury=self.treasury,
            gas_limit=15_000_000 + ANCHOR_GAS_LIMIT,
        )
        if use_blob:
            commitment = eip4844.blob_to_kzg_commitment(tx_data, self.device)
            blob_hash = eip4844.commitment_to_version_hash(commitment)
        else:
            from ..utils import keccak256 as _k

            blob_hash = _k(tx_data)
        meta = BlockMetadata(
            l1_hash=l1_header.hash(),
            difficulty=b"\x11" * 32,
            blob_hash=blob_hash,
            extra_data=header.extra_data[:32].ljust(32, b"\x00"),
            deposits_hash=keccak256(
                abimod.encode([("array", ETH_DEPOSIT_SPEC)], [[]])
            ),
            coinbase=header.beneficiary,
            block_id=header.number,
            gas_limit=header.gas_limit - ANCHOR_GAS_LIMIT,
            timestamp=header.timestamp,
            l1_height=l1_header.number,
            min_tier=100,
            blob_used=use_blob,
            parent_meta_hash=b"\x22" * 32,
            sender=b"\x33" * 20,
        )
        # the proposal tx on L1: blob DA carries the versioned hash, the
        # calldata form carries the tx list in proposeBlock(params, txList)
        proposal_tx = Transaction(
            tx_type=3 if use_blob else 2,
            chain_id=self.l1.spec.chain_id,
            nonce=len(self.l1.txs_by_hash),
            max_priority_fee_per_gas=1,
            max_fee_per_gas=100,
            gas_limit=1_000_000,
            to=self.l1_contract,
            value=0,
            data=l1_data.encode_propose_block(
                b"", b"" if use_blob else tx_data
            ),
            max_fee_per_blob_gas=1 if use_blob else 0,
            blob_versioned_hashes=[blob_hash] if use_blob else [],
        )
        topics, data = l1_data.encode_block_proposed_event(
            header.number, meta.sender, 0, meta
        )
        log = {
            "address": "0x" + self.l1_contract.hex(),
            "topics": ["0x" + t.hex() for t in topics],
            "data": "0x" + data.hex(),
            "transactionHash": "0x" + proposal_tx.hash().hex(),
        }
        inclusion = self.l1.add_da_block([proposal_tx], [log])
        if use_blob:
            slot = (
                inclusion.timestamp - self.l1.spec.genesis_time
            ) // self.l1.spec.seconds_per_slot
            self.l1.blob_sidecars.setdefault(slot, []).append(
                {
                    "index": str(len(self.l1.blob_sidecars.get(slot, []))),
                    "blob": "0x" + tx_data.hex(),
                    "kzg_commitment": "0x" + commitment.hex(),
                    "kzg_proof": "0x",
                }
            )
        return header


# --------------------------------------------------------------------------
# contract calls (the sim analog of the reference's on-chain contracts):
# handlers registered per address answer eth_call
# --------------------------------------------------------------------------


def _install_contract_support(cls):
    def register_contract(self, addr: bytes, handler) -> None:
        self.__dict__.setdefault("contracts", {})[bytes(addr)] = handler

    def eth_call(self, to: bytes, data: bytes) -> bytes:
        handler = self.__dict__.get("contracts", {}).get(bytes(to))
        if handler is None:
            return b""  # calls to codeless addresses return empty
        return handler(data)

    cls.register_contract = register_contract
    cls.eth_call = eth_call
    return cls


_install_contract_support(ChainSim)



# --------------------------------------------------------------------------
# contract-call services: the SGX-verifier registry + the proof verifier
# (see provers/onchain.py for the call shapes)
# --------------------------------------------------------------------------


def install_sgx_verifier(sim, addr: bytes) -> dict:
    """The on-chain SGX-instance registry (reference
    sgx_register_utils.rs): registerInstance(bytes quote, address) ->
    uint32 id.  Mock quotes are validated for the recognizable mock
    header + bound address (the sim stands in for DCAP attestation)."""
    from ..proto import abi
    from ..provers.onchain import decode_register_instance

    registry: dict = {"next_id": 1, "instances": {}}

    def handler(data: bytes) -> bytes:
        quote, instance = decode_register_instance(data)
        if not quote.startswith(b"RAIKO-TPU-MOCK-QUOTE"):
            raise ValueError("bad quote header")
        if quote[20:40] != instance:
            raise ValueError("quote does not bind the instance address")
        iid = registry["next_id"]
        registry["next_id"] += 1
        registry["instances"][iid] = instance
        return abi.encode(["uint32"], [iid])

    sim.register_contract(addr, handler)
    return registry


def install_proof_verifier(sim, addr: bytes, device) -> None:
    """The on-chain proof verifier (reference snarks.rs:159-205):
    verifyProof(bytes32 journal, bytes seal) -> bool, where the seal is
    the constant-shape final artifact and the handler runs the REAL
    STARK verification on ``device`` (None: the CPU)."""
    from ..proto import abi
    from ..provers.onchain import decode_verify_proof, payload_from_seal

    def handler(data: bytes) -> bytes:
        journal, seal = decode_verify_proof(data)
        try:
            payload = payload_from_seal(seal)
        except Exception:
            return abi.encode(["bool"], [False])
        kind = payload.get("kind", "")
        ok = False
        if kind == "seal-v2-artifact":
            # whole-payload recursion seal (provers/seal.py): the outer
            # proof covers EVERY inner STARK of the block payload
            from ..provers.seal import verify_seal_artifact

            ok = verify_seal_artifact(journal, seal, device)
        elif kind == "poseidon2-transcript-sharded-recursive-v1":
            from ..provers.tpu_shard import verify_sharded_recursive

            ok = verify_sharded_recursive(payload, device) and bytes.fromhex(
                payload["instance_hash"]
            ) == journal
        elif kind == "poseidon2-transcript-v1":
            from ..provers.tpu_stark import verify_payload

            ok = verify_payload(payload, device) and bytes.fromhex(
                payload["instance_hash"]
            ) == journal
        return abi.encode(["bool"], [ok])

    sim.register_contract(addr, handler)
