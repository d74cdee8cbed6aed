"""Optimistic provider-backed database for preflight
(reference core/src/provider/db.rs).

Wraps a BlockDataProvider as an EVM Database: state reads during the
optimistic re-execution loop return defaults for unknown data while
recording the misses; ``fetch_data`` batch-resolves everything recorded and
reports whether the run was clean (ref :298-364).  Also collects the full
access sets the proof phase needs (``get_proofs``, ref :77-120) and the
ancestor-header walk (ref :122-149)."""

from __future__ import annotations

from ..evm.state import AccountInfo, Database
from .provider import BlockDataProvider


class ProviderDb(Database):
    def __init__(self, provider: BlockDataProvider, parent_block: int, parent_header):
        self.provider = provider
        self.parent_block = parent_block
        self.parent_header = parent_header
        self.accounts: dict[bytes, AccountInfo] = {}
        self.storage_values: dict[tuple[bytes, int], int] = {}
        self.block_hashes: dict[int, bytes] = {parent_block: parent_header.hash()}
        self.pending_accounts: set[bytes] = set()
        self.pending_slots: set[tuple[bytes, int]] = set()
        self.pending_block_hashes: set[int] = set()
        # full access log for proof collection
        self.accessed_accounts: set[bytes] = set()
        self.accessed_slots: set[tuple[bytes, int]] = set()

    # -- Database interface (optimistic) --------------------------------
    def basic(self, address: bytes):
        self.accessed_accounts.add(address)
        if address not in self.accounts:
            self.pending_accounts.add(address)
            return None  # optimistic default: absent account
        info = self.accounts[address]
        return None if info is None else info

    def storage(self, address: bytes, slot: int):  # type: ignore[override]
        self.accessed_accounts.add(address)
        self.accessed_slots.add((address, slot))
        key = (address, slot)
        if key not in self.storage_values:
            self.pending_slots.add(key)
            return 0
        return self.storage_values[key]

    def block_hash(self, number: int) -> bytes:
        if number not in self.block_hashes:
            self.pending_block_hashes.add(number)
            return b"\x00" * 32
        return self.block_hashes[number]

    # -- batch resolution -------------------------------------------------
    def fetch_data(self) -> bool:
        """Resolve pending sets; returns True if the previous run was
        clean (nothing was missing)."""
        clean = not (
            self.pending_accounts or self.pending_slots or self.pending_block_hashes
        )
        if self.pending_accounts:
            addrs = sorted(self.pending_accounts)
            infos = self.provider.get_accounts(self.parent_block, addrs)
            for a, info in zip(addrs, infos):
                exists = info["nonce"] or info["balance"] or info["code"]
                self.accounts[a] = AccountInfo(
                    nonce=info["nonce"],
                    balance=info["balance"],
                    code=info["code"],
                    exists=bool(exists),
                )
            self.pending_accounts.clear()
        if self.pending_slots:
            keys = sorted(self.pending_slots)
            vals = self.provider.get_storage_values(self.parent_block, keys)
            for k, v in zip(keys, vals):
                self.storage_values[k] = v
            self.pending_slots.clear()
        if self.pending_block_hashes:
            numbers = sorted(self.pending_block_hashes)
            blocks = self.provider.get_blocks(numbers)
            for n, (h, _, _) in zip(numbers, blocks):
                self.block_hashes[n] = h.hash()
            self.pending_block_hashes.clear()
        return clean

    # -- proof phase ------------------------------------------------------
    def proof_keys(self) -> dict[bytes, list[int]]:
        out: dict[bytes, list[int]] = {a: [] for a in self.accessed_accounts}
        for a, s in self.accessed_slots:
            out.setdefault(a, []).append(s)
        for a in out:
            out[a] = sorted(set(out[a]))
        return out

    def get_proofs(self, current_block: int):
        keys = self.proof_keys()
        initial = self.provider.get_merkle_proofs(self.parent_block, keys)
        final = self.provider.get_merkle_proofs(current_block, keys)
        return initial, final

    def get_ancestor_headers(self) -> list:
        """Parent-1 down to the oldest accessed block hash (ref :122-149)."""
        accessed = [n for n in self.block_hashes if n < self.parent_block]
        if not self.pending_block_hashes and not accessed:
            return []
        oldest = min(accessed) if accessed else self.parent_block
        if oldest >= self.parent_block:
            return []
        numbers = list(range(self.parent_block - 1, oldest - 1, -1))
        return [h for h, _, _ in self.provider.get_blocks(numbers)]
