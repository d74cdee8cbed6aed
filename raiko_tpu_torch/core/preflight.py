"""Preflight: turn (network, block) + provider state into a self-contained
GuestInput (reference core/src/preflight.rs:36-188).

Steps mirrored from the reference:
1. fetch the block + parent,
2. Taiko: assemble the L1-side data (proposal metadata, tx-list blob,
   anchor tx, blob commitment; ref prepare_taiko_chain_input :191-280),
3. iterative optimistic execution (<= 100 rounds) batching missing state
   through ProviderDb (ref :116-139),
4. EIP-1186 proofs for initial + final state -> sparse tries (:146-157),
5. ancestor headers + contract bytecodes (:160-176),
6. assemble the GuestInput.
"""

from __future__ import annotations

from ..chain import SupportedChainSpecs
from ..evm.execute import execute_block_txs, apply_withdrawals
from ..evm.interpreter import BlockEnv
from ..evm.state import StateJournal
from ..kzg import eip4844
from ..mpt import proofs_to_tries
from ..proto.input import GuestInput, TaikoGuestInput
from ..proto.types import BlockHeader
from ..utils.measurement import Measurement
from ..utils.txlist import generate_transactions
from . import l1_data
from .interfaces import PreflightError, ProofRequest
from .provider import provider_for
from .provider_db import ProviderDb

MAX_OPTIMISTIC_ITERATIONS = 100


def preflight(
    request: ProofRequest, chain_specs: SupportedChainSpecs, device
) -> GuestInput:
    """The block's guest input; its KZG MSMs and batched sender recovery
    run on `device` (a torch device, or None for the host path).  Its steps
    are the spans ``preflight.l1``, ``preflight.execute`` and
    ``preflight.witness``."""
    spec = chain_specs.get(request.network)
    provider = provider_for(spec)
    n = request.block_number
    blocks = provider.get_blocks([n, n - 1])
    (header, txs, withdrawals), (parent, _, _) = blocks[0], blocks[1]

    taiko = TaikoGuestInput()
    if spec.is_taiko:
        with Measurement("preflight.l1"):
            taiko = prepare_taiko_chain_input(request, spec, chain_specs, header, txs, device)
    taiko.prover_data_prover = _hexaddr(request.prover)
    taiko.prover_data_graffiti = _hex32(request.graffiti)

    # decoding the block's transactions and the optimistic execution loop
    # (ref :116-139)
    with Measurement("preflight.execute"):
        if spec.is_taiko:
            exec_txs = generate_transactions(
                spec,
                taiko.block_proposed_meta.blob_used,
                taiko.tx_data,
                taiko.anchor_tx,
            )
        else:
            exec_txs = txs
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
        treasury = None
        if spec.is_taiko and spec.l2_contract:
            treasury = bytes.fromhex(spec.l2_contract[2:].zfill(40))

        db = ProviderDb(provider, n - 1, parent)
        for _ in range(MAX_OPTIMISTIC_ITERATIONS):
            state = StateJournal(db)
            execute_block_txs(
                state,
                env,
                exec_txs,
                is_taiko=spec.is_taiko,
                treasury=treasury,
                optimistic=True,
                device=device,
            )
            apply_withdrawals(state, withdrawals)
            if db.fetch_data():
                break
        else:
            raise PreflightError("optimistic execution did not converge")

    with Measurement("preflight.witness"):
        # proofs -> sparse tries; final proofs resolve orphaned siblings of
        # deleted keys (ref :146-157, :1116-1133)
        initial_proofs, final_proofs = db.get_proofs(n)
        state_trie, storage_tries = proofs_to_tries(
            parent.state_root, initial_proofs, final_proofs
        )
        proof_keys = db.proof_keys()
        parent_storage = {
            addr: (storage_tries.get(addr), proof_keys.get(addr, []))
            for addr in initial_proofs
        }
        contracts = sorted(
            {info.code for info in db.accounts.values() if info and info.code}
        )
        ancestor_headers = db.get_ancestor_headers()
    return GuestInput(
        chain_spec=spec,
        block_header=header,
        transactions=txs,
        withdrawals=withdrawals,
        parent_header=parent,
        parent_state_trie=state_trie,
        parent_storage=parent_storage,
        contracts=contracts,
        ancestor_headers=ancestor_headers,
        taiko=taiko,
    )


def prepare_taiko_chain_input(
    request: ProofRequest,
    spec,
    chain_specs: SupportedChainSpecs,
    header: BlockHeader,
    txs,
    device,
) -> TaikoGuestInput:
    """L1-side data assembly (ref :191-280), entirely through provider
    wire calls:

    1. decode the anchor tx -> the anchored L1 state block; the proposal
       lives in the next L1 block (ref :202-206),
    2. fetch both L1 headers (ref :215-220),
    3. find the BlockProposed event by log filter at the inclusion block
       and fetch the proposing tx (ref :233-240, l1_data.py),
    4. blob DA: slot from the inclusion timestamp, sidecars from the
       beacon API (blobscan fallback), matched by versioned hash and
       re-committed locally; calldata DA: decode proposeBlock calldata
       (ref :243-267).
    """
    l1_spec = chain_specs.get(request.l1_network)
    l1_provider = provider_for(l1_spec)
    if not txs:
        raise PreflightError("taiko block without anchor tx")
    anchor_tx = txs[0]
    anchor_call = l1_data.decode_anchor(anchor_tx.data)
    l1_state_block_number = anchor_call.l1_block_id
    l1_inclusion_block_number = l1_state_block_number + 1

    l1_blocks = l1_provider.get_blocks(
        [l1_inclusion_block_number, l1_state_block_number]
    )
    (l1_inclusion_header, _, _), (l1_state_header, _, _) = l1_blocks
    if l1_state_header.hash() != anchor_call.l1_hash:
        raise PreflightError("anchored L1 block hash mismatch")

    proposal_tx, meta = l1_data.get_block_proposed_event(
        l1_provider, spec, l1_inclusion_header.hash(), header.number
    )

    blob_commitment = None
    if meta.blob_used:
        blob_hashes = proposal_tx.blob_versioned_hashes
        if not blob_hashes:
            raise PreflightError("blob hashes are empty")
        # the protocol enforces the first blob hash (ref :247-249)
        blob_hash = bytes(blob_hashes[0])
        slot = l1_data.block_time_to_block_slot(
            l1_inclusion_header.timestamp,
            l1_spec.genesis_time,
            l1_spec.seconds_per_slot,
        )
        tx_data = l1_data.get_blob_data(l1_spec, slot, blob_hash, device)
        with Measurement("kzg.commit"):
            blob_commitment = eip4844.blob_to_kzg_commitment(tx_data, device)
        if eip4844.commitment_to_version_hash(blob_commitment) != meta.blob_hash:
            raise PreflightError("blob versioned hash mismatch")
    else:
        _params, tx_data = l1_data.decode_propose_block(proposal_tx.data)
    return TaikoGuestInput(
        l1_header=l1_state_header,
        tx_data=tx_data,
        anchor_tx=anchor_tx,
        block_proposed_meta=meta,
        blob_commitment=blob_commitment,
        blob_proof_type=request.blob_proof_type,
    )


def _hexaddr(s: str) -> bytes:
    return bytes.fromhex(s[2:].zfill(40)) if s.startswith("0x") else bytes.fromhex(s)


def _hex32(s: str) -> bytes:
    return bytes.fromhex(s[2:].zfill(64)) if s.startswith("0x") else bytes.fromhex(s)
