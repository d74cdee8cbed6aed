"""Transaction execution + deterministic block building.

The Python/TPU analog of reference lib/src/builder.rs: given a database and
an ordered tx list, re-execute every transaction under consensus rules
(intrinsic gas, EIP-1559 fee market, EIP-2929 warm-up, refunds, coinbase
payment), then ``finalize`` the sparse MPTs into the new state root.

Taiko mode (is_taiko): the first transaction is the anchor tx — it must be
sent by the golden-touch address and executes with its fee payment waived;
the base-fee portion of every other tx's fees is routed to the L2 treasury
contract instead of being burned (reference taiko-reth patch behaviour)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..mpt import MptNode, to_nibs, EMPTY_ROOT
from ..proto import rlp
from ..proto.types import (
    Account,
    BlockHeader,
    Receipt,
    Transaction,
    Withdrawal,
    combine_blooms,
    logs_bloom,
    KECCAK_EMPTY,
)
from ..utils import keccak256
from ..utils.measurement import Measurement
from .interpreter import EVM, BlockEnv, TxEnv
from .state import StateJournal

GOLDEN_TOUCH = bytes.fromhex("0000777735367b36bC9B61C50022d9D0700dB4Ec".replace("0x", ""))
ANCHOR_GAS_LIMIT = 250_000


class BlockError(Exception):
    pass


@dataclass
class TxResult:
    success: bool
    gas_used: int
    logs: list
    output: bytes = b""


def next_base_fee(parent, constants) -> int:
    """EIP-1559 base fee for the child of ``parent`` (standard formula,
    parameterized by the chain's eip_1559_constants)."""
    if parent.base_fee_per_gas is None:
        return 0
    parent_fee = parent.base_fee_per_gas
    target = parent.gas_limit // constants.elasticity_multiplier
    if parent.gas_used == target or target == 0:
        return parent_fee
    if parent.gas_used > target:
        delta = max(
            1,
            parent_fee
            * (parent.gas_used - target)
            // target
            // constants.base_fee_change_denominator,
        )
        return parent_fee + delta
    delta = (
        parent_fee
        * (target - parent.gas_used)
        // target
        // constants.base_fee_change_denominator
    )
    return parent_fee - delta


def validate_anchor_tx(tx: Transaction, spec) -> None:
    """Taiko anchor-tx shape checks (reference taiko consensus rules):
    first tx, golden-touch sender (checked by the executor), targets the
    L2 contract, anchor gas limit, zero value."""
    if spec.l2_contract:
        expect_to = bytes.fromhex(spec.l2_contract[2:].zfill(40))
        if tx.to != expect_to:
            raise BlockError("anchor tx does not target the L2 contract")
    if tx.gas_limit != ANCHOR_GAS_LIMIT:
        raise BlockError("anchor tx gas limit mismatch")
    if tx.value != 0:
        raise BlockError("anchor tx must carry no value")


def intrinsic_gas(tx: Transaction, is_create: bool) -> int:
    gas = 21000
    for b in tx.data:
        gas += 4 if b == 0 else 16
    for item in tx.access_list:
        addr_keys = item if isinstance(item, list) else item.rlp_item()
        gas += 2400 + 1900 * len(addr_keys[1])
    if is_create:
        gas += 32000 + 2 * ((len(tx.data) + 31) // 32)  # EIP-3860
    return gas


def execute_transaction(
    state: StateJournal,
    block: BlockEnv,
    tx: Transaction,
    sender: bytes,
    is_taiko: bool = False,
    is_anchor: bool = False,
    treasury: bytes | None = None,
    tracer=None,
    frame_log: list | None = None,
) -> TxResult:
    """Execute one transaction.  Raises BlockError on invalid txs (a block
    containing one is invalid)."""
    state.begin_tx()
    is_create = tx.to is None
    base_fee = block.base_fee
    gas_price = tx.effective_gas_price(base_fee)
    if not is_anchor:
        if tx.tx_type in (2, 3):
            if tx.max_fee_per_gas < base_fee:
                raise BlockError("max fee below base fee")
            if tx.max_priority_fee_per_gas > tx.max_fee_per_gas:
                raise BlockError("priority fee above max fee")
        elif gas_price < base_fee:
            raise BlockError("gas price below base fee")
    # nonce
    if state.nonce(sender) != tx.nonce:
        raise BlockError(
            f"nonce mismatch: state {state.nonce(sender)} vs tx {tx.nonce}"
        )
    if len(state.code(sender)) > 0:
        raise BlockError("sender is a contract (EIP-3607)")
    ig = intrinsic_gas(tx, is_create)
    if tx.gas_limit < ig:
        raise BlockError("intrinsic gas exceeds limit")
    # blob checks
    blob_fee = 0
    if tx.tx_type == 3:
        if not tx.blob_versioned_hashes:
            raise BlockError("blob tx without blobs")
        if any(h[0] != 1 for h in tx.blob_versioned_hashes):
            raise BlockError("bad blob hash version")
        if tx.max_fee_per_blob_gas < block.blob_base_fee:
            raise BlockError("blob fee below base")
        blob_fee = 131072 * len(tx.blob_versioned_hashes) * block.blob_base_fee
    # buy gas
    upfront = tx.gas_limit * gas_price + blob_fee
    max_upfront = (
        tx.gas_limit * (tx.max_fee_per_gas if tx.tx_type in (2, 3) else tx.gas_price)
        + (131072 * len(tx.blob_versioned_hashes) * tx.max_fee_per_blob_gas if tx.tx_type == 3 else 0)
    )
    if not is_anchor:
        if state.balance(sender) < max_upfront + tx.value:
            raise BlockError("insufficient balance for gas + value")
        state.sub_balance(sender, upfront)
    state.set_nonce(sender, tx.nonce + 1)
    # warm-up (EIP-2929 / 3651)
    state.access_account(sender)
    state.access_account(block.coinbase)
    if tx.to is not None:
        state.access_account(tx.to)
    for i in range(1, 11):
        state.access_account(bytes(19) + bytes([i]))
    prewarm_slots: set[int] = set()
    prewarm_slot_map: dict[bytes, set[int]] = {}
    for item in tx.access_list:
        addr_keys = item if isinstance(item, list) else item.rlp_item()
        state.access_account(bytes(addr_keys[0]))
        for k in addr_keys[1]:
            slot = int.from_bytes(k, "big")
            state.access_slot(bytes(addr_keys[0]), slot)
            prewarm_slot_map.setdefault(bytes(addr_keys[0]), set()).add(slot)
            if tx.to is not None and bytes(addr_keys[0]) == tx.to:
                prewarm_slots.add(slot)
    # tx-start warm ADDRESS set (EIP-2929/3651): the frame replay's
    # address-journal prewarm baseline (stark/airs/evm_call.py)
    prewarm_addrs = {int.from_bytes(a, "big") for a in state.warm_accounts}

    acct_log: dict = {}

    def _frame_start_balances(st, snd, to, value):
        out = {
            int.from_bytes(a, "big"): v for a, v in (st.bal_orig or {}).items()
        }
        if value and to is not None:
            # bal_orig marks sit before the entry transfer; shift
            # sender/recipient to their frame-start values
            snd_i = int.from_bytes(snd, "big")
            to_i = int.from_bytes(to, "big")
            if snd_i in out:
                out[snd_i] -= value
            if to_i in out:
                out[to_i] += value
        return out

    evm = EVM(
        state,
        block,
        TxEnv(origin=sender, gas_price=gas_price, blob_hashes=list(tx.blob_versioned_hashes)),
        is_taiko=is_taiko,
        tracer=tracer,
        acct_log=acct_log,
    )
    gas_exec = tx.gas_limit - ig
    frame_code = b"" if is_create else state.code(tx.to)
    # balance originals for the EVM balance journal: the mark sits right
    # before frame entry; the tx.value transfer happens inside evm.call,
    # so the candidate adjusts sender/to below to frame-start values
    state.mark_balance_origins()
    if is_create:
        # create() computes the address from sender nonce - 1 (already bumped)
        res = evm.create(sender, tx.value, tx.data, gas_exec)
    else:
        res = evm.call(sender, tx.to, tx.value, tx.data, gas_exec)
    if frame_log is not None and frame_code:
        # top-level call-frame candidate for the EVM execution STARK
        # (stark/airs/evm_air.py); the prover replays it with the covered
        # stack machine and proves it when the frame stays in-coverage
        frame_log.append(
            {
                "code": frame_code,
                "gas": gas_exec,
                "gas_left": res.gas_left,
                "success": res.success,
                "address": int.from_bytes(tx.to, "big"),
                "origin": int.from_bytes(sender, "big"),
                "caller": int.from_bytes(sender, "big"),
                "callvalue": tx.value,
                "calldata": tx.data,
                "calldatasize": len(tx.data),
                # pre-state storage originals (EIP-2200 per-tx semantics)
                # + the tx access list's pre-warmed slots, for the
                # storage-journal statement (stark/airs/evm_storage.py)
                "storage": {
                    slot: val
                    for (addr, slot), val in state.orig_storage.items()
                    if addr == tx.to
                },
                "warm_slots": sorted(prewarm_slots),
                # world view for CALL composition: every touched account
                # with code + its storage originals, and the tx-start
                # warm address set (docs/EVM_COMPOSITION.md)
                "world": {
                    int.from_bytes(a, "big"): {
                        "code": state.code(a),
                        "storage": {
                            slot: val
                            for (aa, slot), val in state.orig_storage.items()
                            if aa == a
                        },
                        "warm_slots": sorted(
                            prewarm_slot_map.get(a, ())
                        ),
                    }
                    for a in list(state.accounts)
                    if state.code(a)
                },
                "warm_addresses": sorted(prewarm_addrs),
                # frame-start balances (post tx.value entry transfer) of
                # every address whose balance the frame touched — the
                # PUBLIC originals of the balance journal (EvmBalanceAir)
                "balances": _frame_start_balances(
                    state, sender, tx.to, tx.value
                ),
                # frame-start nonces (CREATE address derivations)
                "nonces": {
                    int.from_bytes(a, "big"): v
                    for a, v in (getattr(state, "nonce_orig", None) or {}).items()
                },
                # account-context reads actually observed (value-exact;
                # keys poisoned to None on mid-tx divergence)
                "acct_ctx": {
                    k: v for k, v in acct_log.items() if v is not None
                },
                "gasprice": gas_price,
                "coinbase": int.from_bytes(block.coinbase, "big"),
                "timestamp": block.timestamp,
                "number": block.number,
                "prevrandao": int.from_bytes(block.prevrandao, "big"),
                "gaslimit": block.gas_limit,
                "chainid": block.chain_id,
                "basefee": block.base_fee,
                "blobbasefee": block.blob_base_fee,
            }
        )
    used = tx.gas_limit - res.gas_left
    # refunds (EIP-3529: capped at 1/5 of used; none on revert-to-zero txs)
    if not res.success:
        state.refund = 0
    used -= min(state.refund, used // 5)
    gas_left = tx.gas_limit - used
    if not is_anchor:
        state.add_balance(sender, gas_left * gas_price)
        state.add_balance(block.coinbase, used * max(gas_price - base_fee, 0))
        if is_taiko and treasury is not None:
            state.add_balance(treasury, used * base_fee)
    logs = list(state.logs)
    state.finish_tx()
    return TxResult(res.success, used, logs, res.output)


@dataclass
class BlockResult:
    receipts: list
    gas_used: int
    logs_bloom: bytes
    senders: list


_BATCH_RECOVER_MIN = 16


def _batch_recover_senders(txs, device) -> list | None:
    """Every tx sender from one batched recovery on `device` (reference
    analog: with_recovered_senders, lib/src/builder.rs:108-110; SURVEY §2.2
    "batched ecrecover kernel").  Returns a list aligned with txs whose
    entries are 20-byte addresses or the per-tx ValueError to raise at
    that tx's slot; None when there is no device, the device is the CPU
    or the batch is small (per-tx host recovery is cheaper there)."""
    if device is None or len(txs) < _BATCH_RECOVER_MIN:
        return None
    from ..ops import secp

    if not secp.use_device_recovery(device):
        return None
    with Measurement("evm.senders"):
        return secp.recover_senders(txs, device)


def execute_block_txs(
    state: StateJournal,
    block: BlockEnv,
    txs: list[Transaction],
    is_taiko: bool = False,
    treasury: bytes | None = None,
    senders: list[bytes] | None = None,
    optimistic: bool = False,
    trace_dir: str | None = None,
    frame_log: list | None = None,
    *,
    device,
) -> BlockResult:
    """Execute all txs in order with consensus validations
    (reference builder.rs:76-186).

    ``trace_dir`` (or env RAIKO_TRACE_DIR) dumps a geth-style structLog
    JSON per tx — the reference's execution-trace feature (README
    "Execution Trace"; traces land in <dir>/<block>-<txidx>.json).

    ``device`` (a torch device) recovers the senders of 16 or more txs in
    one batch there; None recovers each on the host."""
    import os as _os

    trace_dir = trace_dir or _os.environ.get("RAIKO_TRACE_DIR") or None
    receipts = []
    cumulative = 0
    recovered = []
    batch_senders = None if senders else _batch_recover_senders(txs, device)
    for i, tx in enumerate(txs):
        tracer = None
        if trace_dir:
            from .tracer import StructTracer

            tracer = StructTracer()
        try:
            if senders:
                sender = senders[i]
            elif batch_senders is not None:
                sender = batch_senders[i]
                if isinstance(sender, Exception):
                    raise sender
            else:
                sender = tx.recover_sender()
            recovered.append(sender)
            is_anchor = is_taiko and i == 0
            if is_anchor and sender != GOLDEN_TOUCH:
                raise BlockError("anchor tx not from golden-touch address")
            if tx.chain_id is not None and tx.chain_id != block.chain_id:
                raise BlockError("wrong chain id")
            if cumulative + tx.gas_limit > block.gas_limit:
                raise BlockError("block gas limit exceeded")
            frames_before = len(frame_log) if frame_log is not None else 0
            result = execute_transaction(
                state, block, tx, sender, is_taiko, is_anchor, treasury,
                tracer=tracer, frame_log=frame_log,
            )
            if frame_log is not None:
                # stamp the tx index: the receipts-link payload aligns
                # proven frame logs with receipt entries by it
                for cand in frame_log[frames_before:]:
                    cand["tx_index"] = i
        except (BlockError, ValueError):
            if optimistic:
                # data-gathering run: keep executing the rest of the block
                receipts.append(None)
                continue
            raise
        cumulative += result.gas_used
        if tracer is not None:
            from .tracer import write_trace

            write_trace(
                trace_dir,
                block.number,
                i,
                tracer.finish(
                    tx.hash(), result.gas_used, not result.success, result.output
                ),
            )
        receipts.append(
            Receipt(tx.tx_type, 1 if result.success else 0, cumulative, result.logs)
        )
    blooms = [r.bloom() for r in receipts if r is not None]
    return BlockResult(
        receipts=[r for r in receipts if r is not None],
        gas_used=cumulative,
        logs_bloom=combine_blooms(blooms) if blooms else bytes(256),
        senders=recovered,
    )


def apply_withdrawals(state: StateJournal, withdrawals: list[Withdrawal]):
    for w in withdrawals:
        if w.amount > 0:
            state.add_balance(w.address, w.amount * 10**9)
            state.all_touched.add(w.address)


def finalize_state_root(
    state: StateJournal,
    state_trie: MptNode,
    storage_tries: dict,
) -> bytes:
    """Apply accumulated state changes to the sparse tries and recompute the
    root (reference builder.rs:191-264 calculate_state_root)."""
    for addr in sorted(state.all_touched | state.all_selfdestructed):
        key = to_nibs(keccak256(addr))
        acc = state.accounts.get(addr)
        if acc is None:
            continue
        deleted = (not acc.exists) or (
            acc.nonce == 0 and acc.balance == 0 and not acc.code
        )
        if deleted:
            if state_trie.get(key) is not None:
                state_trie.delete(key)
            storage_tries.pop(addr, None)
            continue
        # storage updates
        strie = storage_tries.get(addr)
        if strie is None:
            strie = MptNode.null()
            storage_tries[addr] = strie
        for (a, slot), val in state.storage.items():
            if a != addr:
                continue
            orig = state.orig_storage.get((a, slot))
            if val == orig:
                continue
            skey = to_nibs(keccak256(slot.to_bytes(32, "big")))
            if val == 0:
                if strie.get(skey) is not None:
                    strie.delete(skey)
            else:
                strie.insert(skey, rlp.encode(val))
        account = Account(
            nonce=acc.nonce,
            balance=acc.balance,
            storage_root=strie.hash(),
            code_hash=keccak256(acc.code) if acc.code else KECCAK_EMPTY,
        )
        state_trie.insert(key, account.encode())
    return state_trie.hash()
