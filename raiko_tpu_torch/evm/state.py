"""Journaled EVM state over a pluggable backing database.

Mirrors the role of revm's journaled state + the reference's MemDb
(lib/src/mem_db.rs): account lifecycle (touched / storage-cleared /
deleted), snapshot/revert via an undo journal, warm/cold access tracking
(EIP-2929), transient storage (EIP-1153), and the commit step that the
block builder's finalize uses to update the sparse MPT."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..proto.types import KECCAK_EMPTY
from ..utils import keccak256


@dataclass
class AccountInfo:
    nonce: int = 0
    balance: int = 0
    code: bytes = b""
    exists: bool = False  # pre-state existence


class Database:
    """Backing database interface (reference OptimisticDatabase +
    revm::Database)."""

    def basic(self, address: bytes) -> AccountInfo | None:
        raise NotImplementedError

    def storage(self, address: bytes, slot: int) -> int:
        raise NotImplementedError

    def block_hash(self, number: int) -> bytes:
        raise NotImplementedError


class MemDb(Database):
    """Self-contained database built from GuestInput (reference
    lib/src/mem_db.rs:86-93): accounts + storage + ancestor block hashes."""

    def __init__(self):
        self.accounts: dict[bytes, AccountInfo] = {}
        self.storages: dict[bytes, dict[int, int]] = {}
        self.block_hashes: dict[int, bytes] = {}

    def insert_account(self, address: bytes, info: AccountInfo, storage=None):
        self.accounts[address] = info
        self.storages[address] = dict(storage or {})

    def basic(self, address: bytes):
        return self.accounts.get(address)

    def storage(self, address: bytes, slot: int) -> int:
        return self.storages.get(address, {}).get(slot, 0)

    def block_hash(self, number: int) -> bytes:
        try:
            return self.block_hashes[number]
        except KeyError:
            raise KeyError(f"block hash {number} not provided") from None


class StateJournal:
    """Execution state with snapshot/revert and per-tx bookkeeping."""

    def __init__(self, db: Database):
        self.db = db
        self.accounts: dict[bytes, AccountInfo] = {}
        self.storage: dict[tuple[bytes, int], int] = {}
        self.orig_storage: dict[tuple[bytes, int], int] = {}
        self.transient: dict[tuple[bytes, int], int] = {}
        self.selfdestructed: set[bytes] = set()
        self.created: set[bytes] = set()  # created this TX (EIP-6780)
        self.touched: set[bytes] = set()
        self.warm_accounts: set[bytes] = set()
        self.warm_slots: set[tuple[bytes, int]] = set()
        self.logs: list = []
        self.refund: int = 0
        self._journal: list = []
        # cumulative (block-level) sets for finalize
        self.all_touched: set[bytes] = set()
        self.all_selfdestructed: set[bytes] = set()
        # frame-start balance originals (round 5): after
        # mark_balance_origins(), the first read/write of an address's
        # balance records the value it had AT THE MARK — the per-address
        # originals of the EVM balance journal (stark/airs/evm_call.py
        # EvmBalanceAir)
        self.bal_orig: dict[bytes, int] | None = None
        self.nonce_orig: dict[bytes, int] | None = None

    # -- account loading -------------------------------------------------
    def _load(self, address: bytes) -> AccountInfo:
        acc = self.accounts.get(address)
        if acc is None:
            src = self.db.basic(address)
            if src is None:
                acc = AccountInfo(exists=False)
            else:
                acc = AccountInfo(src.nonce, src.balance, src.code, src.exists)
            self.accounts[address] = acc
        return acc

    def exists(self, address: bytes) -> bool:
        a = self._load(address)
        return a.exists and not self.is_empty(address)

    def is_empty(self, address: bytes) -> bool:
        a = self._load(address)
        return a.nonce == 0 and a.balance == 0 and len(a.code) == 0

    def mark_balance_origins(self):
        """Start recording per-address balance AND nonce originals
        (frame entry) — the PUBLIC starting points of the EVM balance
        journal and the CREATE address derivations."""
        self.bal_orig = {}
        self.nonce_orig = {}

    def _note_bal(self, address: bytes, current: int):
        if self.bal_orig is not None and address not in self.bal_orig:
            self.bal_orig[address] = current

    def _note_nonce(self, address: bytes, current: int):
        if (
            getattr(self, "nonce_orig", None) is not None
            and address not in self.nonce_orig
        ):
            self.nonce_orig[address] = current

    def balance(self, address: bytes) -> int:
        v = self._load(address).balance
        self._note_bal(address, v)
        return v

    def nonce(self, address: bytes) -> int:
        v = self._load(address).nonce
        self._note_nonce(address, v)
        return v

    def code(self, address: bytes) -> bytes:
        if address in self.selfdestructed:
            return b""
        return self._load(address).code

    def code_hash(self, address: bytes) -> bytes:
        a = self._load(address)
        if not a.exists and self.is_empty(address):
            return b"\x00" * 32 if not a.exists else KECCAK_EMPTY
        if self.is_empty(address) and not a.exists:
            return b"\x00" * 32
        return keccak256(a.code) if a.code else KECCAK_EMPTY

    # -- mutation (journaled) ---------------------------------------------
    def _j(self, entry):
        self._journal.append(entry)

    def touch(self, address: bytes):
        if address not in self.touched:
            self.touched.add(address)
            self.all_touched.add(address)
            self._j(("touch", address))

    def set_balance(self, address: bytes, value: int):
        a = self._load(address)
        self._note_bal(address, a.balance)
        self._j(("balance", address, a.balance, a.exists))
        a.balance = value
        a.exists = True
        self.touch(address)

    def add_balance(self, address: bytes, delta: int):
        self.set_balance(address, self._load(address).balance + delta)

    def sub_balance(self, address: bytes, delta: int):
        a = self._load(address)
        assert a.balance >= delta
        self.set_balance(address, a.balance - delta)

    def set_nonce(self, address: bytes, value: int):
        a = self._load(address)
        self._note_nonce(address, a.nonce)
        self._j(("nonce", address, a.nonce, a.exists))
        a.nonce = value
        a.exists = True
        self.touch(address)

    def set_code(self, address: bytes, code: bytes):
        a = self._load(address)
        self._j(("code", address, a.code, a.exists))
        a.code = code
        a.exists = True
        self.touch(address)

    def mark_created(self, address: bytes):
        self._j(("created", address))
        self.created.add(address)
        # EIP-158-ish: creation clears storage view
        a = self._load(address)
        a.exists = True

    def sload(self, address: bytes, slot: int) -> int:
        key = (address, slot)
        if key not in self.storage:
            if address in self.created:
                val = 0
            else:
                val = self.db.storage(address, slot)
            self.storage[key] = val
        # EIP-2200 "original" = committed value at the START OF THIS TX:
        # orig_storage is cleared in begin_tx, so the first access in a tx
        # (every write path sloads first) seeds it from the current value
        self.orig_storage.setdefault(key, self.storage[key])
        return self.storage[key]

    def original_storage(self, address: bytes, slot: int) -> int:
        self.sload(address, slot)
        return self.orig_storage[(address, slot)]

    def sstore(self, address: bytes, slot: int, value: int):
        cur = self.sload(address, slot)
        self._j(("storage", address, slot, cur))
        self.storage[(address, slot)] = value
        self.touch(address)

    def tload(self, address: bytes, slot: int) -> int:
        return self.transient.get((address, slot), 0)

    def tstore(self, address: bytes, slot: int, value: int):
        key = (address, slot)
        self._j(("transient", key, self.transient.get(key, 0)))
        self.transient[key] = value

    def selfdestruct(self, address: bytes) -> bool:
        """Returns True if the account is actually scheduled for deletion
        (EIP-6780: only same-tx creations)."""
        self._j(("selfdestruct", address, address in self.selfdestructed))
        if address in self.created:
            self.selfdestructed.add(address)
            self.all_selfdestructed.add(address)
            return True
        return False

    def add_log(self, log):
        self._j(("log",))
        self.logs.append(log)

    def add_refund(self, delta: int):
        self._j(("refund", self.refund))
        self.refund += delta

    def sub_refund(self, delta: int):
        self._j(("refund", self.refund))
        self.refund -= delta

    # -- warm/cold (EIP-2929) ---------------------------------------------
    def access_account(self, address: bytes) -> bool:
        """Returns True if it was cold."""
        if address in self.warm_accounts:
            return False
        self._j(("warm_acct", address))
        self.warm_accounts.add(address)
        return True

    def access_slot(self, address: bytes, slot: int) -> bool:
        key = (address, slot)
        if key in self.warm_slots:
            return False
        self._j(("warm_slot", key))
        self.warm_slots.add(key)
        return True

    # -- snapshots ---------------------------------------------------------
    def snapshot(self) -> int:
        return len(self._journal)

    def revert(self, snap: int):
        while len(self._journal) > snap:
            entry = self._journal.pop()
            kind = entry[0]
            if kind == "balance":
                _, addr, bal, ex = entry
                a = self.accounts[addr]
                a.balance = bal
                a.exists = ex
            elif kind == "nonce":
                _, addr, nonce, ex = entry
                a = self.accounts[addr]
                a.nonce = nonce
                a.exists = ex
            elif kind == "code":
                _, addr, code, ex = entry
                a = self.accounts[addr]
                a.code = code
                a.exists = ex
            elif kind == "storage":
                _, addr, slot, val = entry
                self.storage[(addr, slot)] = val
            elif kind == "transient":
                _, key, val = entry
                self.transient[key] = val
            elif kind == "selfdestruct":
                _, addr, was = entry
                if not was:
                    self.selfdestructed.discard(addr)
                    self.all_selfdestructed.discard(addr)
            elif kind == "created":
                self.created.discard(entry[1])
            elif kind == "log":
                self.logs.pop()
            elif kind == "refund":
                self.refund = entry[1]
            elif kind == "touch":
                self.touched.discard(entry[1])
            elif kind == "warm_acct":
                self.warm_accounts.discard(entry[1])
            elif kind == "warm_slot":
                self.warm_slots.discard(entry[1])

    # -- per-tx lifecycle ---------------------------------------------------
    def begin_tx(self):
        self.transient.clear()
        self.created.clear()
        self.selfdestructed.clear()
        self.logs = []
        self.refund = 0
        self.warm_accounts = set()
        self.warm_slots = set()
        self.touched = set()
        self._journal = []
        # EIP-2200: "original" storage values reset at each tx boundary
        self.orig_storage = {}

    def finish_tx(self):
        """Apply EIP-6780 selfdestructs + state-clearing of touched empties."""
        for addr in self.selfdestructed:
            self.accounts[addr] = AccountInfo(exists=False)
            for key in [k for k in self.storage if k[0] == addr]:
                del self.storage[key]
        for addr in list(self.touched):
            a = self.accounts.get(addr)
            if a is not None and a.exists and self.is_empty(addr):
                a.exists = False  # EIP-158 state clearing
