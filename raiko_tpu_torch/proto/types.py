"""Ethereum consensus types: headers, transactions, receipts, accounts.

Byte-exact RLP encodings (block hash = keccak(rlp(header)), typed
transactions as type_byte || rlp(payload)), signing hashes per EIP-155/
2930/1559/4844, and sender recovery.  The parity anchors are the reference's
use of reth primitives (lib/src/builder.rs re-execution rebuilds the header
and compares field by field, core/src/lib.rs:123-172)."""

from __future__ import annotations

from dataclasses import dataclass, field

from . import rlp
from ..utils import keccak256
from ..utils import secp256k1

EMPTY_UNCLES_HASH = bytes.fromhex(
    "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347"
)
KECCAK_EMPTY = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
)


def _b(v: int, n: int) -> bytes:
    return v.to_bytes(n, "big")


@dataclass
class BlockHeader:
    parent_hash: bytes = b"\x00" * 32
    ommers_hash: bytes = EMPTY_UNCLES_HASH
    beneficiary: bytes = b"\x00" * 20
    state_root: bytes = b"\x00" * 32
    transactions_root: bytes = b"\x00" * 32
    receipts_root: bytes = b"\x00" * 32
    logs_bloom: bytes = b"\x00" * 256
    difficulty: int = 0
    number: int = 0
    gas_limit: int = 0
    gas_used: int = 0
    timestamp: int = 0
    extra_data: bytes = b""
    mix_hash: bytes = b"\x00" * 32
    nonce: bytes = b"\x00" * 8
    base_fee_per_gas: int | None = None
    withdrawals_root: bytes | None = None
    blob_gas_used: int | None = None
    excess_blob_gas: int | None = None
    parent_beacon_block_root: bytes | None = None

    def fields(self) -> list:
        out = [
            self.parent_hash,
            self.ommers_hash,
            self.beneficiary,
            self.state_root,
            self.transactions_root,
            self.receipts_root,
            self.logs_bloom,
            self.difficulty,
            self.number,
            self.gas_limit,
            self.gas_used,
            self.timestamp,
            self.extra_data,
            self.mix_hash,
            self.nonce,
        ]
        # optional trailing fields: include up to the last Some value
        tail = [
            self.base_fee_per_gas,
            self.withdrawals_root,
            self.blob_gas_used,
            self.excess_blob_gas,
            self.parent_beacon_block_root,
        ]
        last = -1
        for i, v in enumerate(tail):
            if v is not None:
                last = i
        for i in range(last + 1):
            v = tail[i]
            assert v is not None, "gap in optional header fields"
            out.append(v)
        return out

    def encode(self) -> bytes:
        return rlp.encode(self.fields())

    def hash(self) -> bytes:
        return keccak256(self.encode())

    @classmethod
    def decode(cls, data: bytes) -> "BlockHeader":
        items = rlp.decode(data)
        h = cls(
            parent_hash=items[0],
            ommers_hash=items[1],
            beneficiary=items[2],
            state_root=items[3],
            transactions_root=items[4],
            receipts_root=items[5],
            logs_bloom=items[6],
            difficulty=rlp.decode_int(items[7]),
            number=rlp.decode_int(items[8]),
            gas_limit=rlp.decode_int(items[9]),
            gas_used=rlp.decode_int(items[10]),
            timestamp=rlp.decode_int(items[11]),
            extra_data=items[12],
            mix_hash=items[13],
            nonce=items[14],
        )
        opt = items[15:]
        if len(opt) > 0:
            h.base_fee_per_gas = rlp.decode_int(opt[0])
        if len(opt) > 1:
            h.withdrawals_root = opt[1]
        if len(opt) > 2:
            h.blob_gas_used = rlp.decode_int(opt[2])
        if len(opt) > 3:
            h.excess_blob_gas = rlp.decode_int(opt[3])
        if len(opt) > 4:
            h.parent_beacon_block_root = opt[4]
        return h


@dataclass
class AccessListItem:
    address: bytes
    storage_keys: list

    def rlp_item(self):
        return [self.address, list(self.storage_keys)]


@dataclass
class Transaction:
    """Unified transaction.  tx_type: 0 legacy, 1 eip2930, 2 eip1559,
    3 eip4844."""

    tx_type: int = 0
    chain_id: int | None = None  # None = pre-EIP-155 legacy
    nonce: int = 0
    gas_price: int = 0  # legacy/2930
    max_priority_fee_per_gas: int = 0  # 1559/4844
    max_fee_per_gas: int = 0
    gas_limit: int = 0
    to: bytes | None = None  # None = create
    value: int = 0
    data: bytes = b""
    access_list: list = field(default_factory=list)
    max_fee_per_blob_gas: int = 0
    blob_versioned_hashes: list = field(default_factory=list)
    v: int = 0  # legacy: full v (EIP-155); typed: y_parity
    r: int = 0
    s: int = 0

    # -- encoding -------------------------------------------------------
    def _to_item(self):
        return self.to if self.to is not None else b""

    def _al_items(self):
        return [a.rlp_item() if isinstance(a, AccessListItem) else a for a in self.access_list]

    def payload_fields(self, for_signing: bool) -> list:
        if self.tx_type == 0:
            f = [
                self.nonce,
                self.gas_price,
                self.gas_limit,
                self._to_item(),
                self.value,
                self.data,
            ]
            if for_signing:
                if self.chain_id is not None:  # EIP-155
                    f += [self.chain_id, 0, 0]
            else:
                f += [self.v, self.r, self.s]
            return f
        if self.tx_type == 1:
            f = [
                self.chain_id,
                self.nonce,
                self.gas_price,
                self.gas_limit,
                self._to_item(),
                self.value,
                self.data,
                self._al_items(),
            ]
        elif self.tx_type == 2:
            f = [
                self.chain_id,
                self.nonce,
                self.max_priority_fee_per_gas,
                self.max_fee_per_gas,
                self.gas_limit,
                self._to_item(),
                self.value,
                self.data,
                self._al_items(),
            ]
        elif self.tx_type == 3:
            f = [
                self.chain_id,
                self.nonce,
                self.max_priority_fee_per_gas,
                self.max_fee_per_gas,
                self.gas_limit,
                self.to or b"",
                self.value,
                self.data,
                self._al_items(),
                self.max_fee_per_blob_gas,
                list(self.blob_versioned_hashes),
            ]
        else:
            raise ValueError(f"unknown tx type {self.tx_type}")
        if not for_signing:
            f += [self.v, self.r, self.s]
        return f

    def encode(self) -> bytes:
        """Consensus encoding (as placed in the tx trie / block body)."""
        payload = rlp.encode(self.payload_fields(for_signing=False))
        if self.tx_type == 0:
            return payload
        return bytes([self.tx_type]) + payload

    def signing_hash(self) -> bytes:
        payload = rlp.encode(self.payload_fields(for_signing=True))
        if self.tx_type == 0:
            return keccak256(payload)
        return keccak256(bytes([self.tx_type]) + payload)

    def hash(self) -> bytes:
        return keccak256(self.encode())

    # -- signature ------------------------------------------------------
    def signature_parts(self) -> tuple[bytes, int]:
        """(signing_hash, rec_id) after v / chain-id / EIP-2 validation.
        Shared by per-tx recovery and the batched TPU path
        (ops/secp.recover_pubkeys_batch)."""
        if self.tx_type == 0:
            if self.v >= 35:  # EIP-155
                rec_id = (self.v - 35) % 2
                chain_id = (self.v - 35 - rec_id) // 2
                if self.chain_id is None:
                    self.chain_id = chain_id
                elif self.chain_id != chain_id:
                    raise ValueError("chain id mismatch in signature")
            elif self.v in (27, 28):
                rec_id = self.v - 27
                self.chain_id = None
            else:
                raise ValueError(f"invalid legacy v {self.v}")
        else:
            rec_id = self.v
            if rec_id not in (0, 1):
                raise ValueError(f"invalid y_parity {self.v}")
        # EIP-2: high-s signatures invalid since homestead
        if self.s > secp256k1.N // 2:
            raise ValueError("high-s signature")
        return self.signing_hash(), rec_id

    def recover_sender(self) -> bytes:
        msg_hash, rec_id = self.signature_parts()
        addr = secp256k1.ecrecover(msg_hash, 27 + rec_id, self.r, self.s)
        if addr is None:
            raise ValueError("signature recovery failed")
        return addr

    def sign(self, secret: int, chain_id: int | None = None) -> "Transaction":
        if chain_id is not None:
            self.chain_id = chain_id
        r, s, rec = secp256k1.sign(self.signing_hash(), secret)
        self.r, self.s = r, s
        if self.tx_type == 0:
            if self.chain_id is not None:
                self.v = 35 + 2 * self.chain_id + rec
            else:
                self.v = 27 + rec
        else:
            self.v = rec
        return self

    @classmethod
    def decode(cls, data: bytes) -> "Transaction":
        if data and data[0] <= 0x7F:  # typed
            tx_type = data[0]
            items = rlp.decode(data[1:])
            if tx_type == 1:
                tx = cls(
                    tx_type=1,
                    chain_id=rlp.decode_int(items[0]),
                    nonce=rlp.decode_int(items[1]),
                    gas_price=rlp.decode_int(items[2]),
                    gas_limit=rlp.decode_int(items[3]),
                    to=items[4] or None,
                    value=rlp.decode_int(items[5]),
                    data=items[6],
                    access_list=items[7],
                    v=rlp.decode_int(items[8]),
                    r=rlp.decode_int(items[9]),
                    s=rlp.decode_int(items[10]),
                )
            elif tx_type == 2:
                tx = cls(
                    tx_type=2,
                    chain_id=rlp.decode_int(items[0]),
                    nonce=rlp.decode_int(items[1]),
                    max_priority_fee_per_gas=rlp.decode_int(items[2]),
                    max_fee_per_gas=rlp.decode_int(items[3]),
                    gas_limit=rlp.decode_int(items[4]),
                    to=items[5] or None,
                    value=rlp.decode_int(items[6]),
                    data=items[7],
                    access_list=items[8],
                    v=rlp.decode_int(items[9]),
                    r=rlp.decode_int(items[10]),
                    s=rlp.decode_int(items[11]),
                )
            elif tx_type == 3:
                tx = cls(
                    tx_type=3,
                    chain_id=rlp.decode_int(items[0]),
                    nonce=rlp.decode_int(items[1]),
                    max_priority_fee_per_gas=rlp.decode_int(items[2]),
                    max_fee_per_gas=rlp.decode_int(items[3]),
                    gas_limit=rlp.decode_int(items[4]),
                    to=items[5] or None,
                    value=rlp.decode_int(items[6]),
                    data=items[7],
                    access_list=items[8],
                    max_fee_per_blob_gas=rlp.decode_int(items[9]),
                    blob_versioned_hashes=items[10],
                    v=rlp.decode_int(items[11]),
                    r=rlp.decode_int(items[12]),
                    s=rlp.decode_int(items[13]),
                )
            else:
                raise ValueError(f"unknown tx type {tx_type}")
            return tx
        items = rlp.decode(data)
        tx = cls(
            tx_type=0,
            nonce=rlp.decode_int(items[0]),
            gas_price=rlp.decode_int(items[1]),
            gas_limit=rlp.decode_int(items[2]),
            to=items[3] or None,
            value=rlp.decode_int(items[4]),
            data=items[5],
            v=rlp.decode_int(items[6]),
            r=rlp.decode_int(items[7]),
            s=rlp.decode_int(items[8]),
        )
        if tx.v >= 35:
            tx.chain_id = (tx.v - 35) // 2
        return tx

    def effective_gas_price(self, base_fee: int) -> int:
        if self.tx_type in (0, 1):
            return self.gas_price
        return min(self.max_fee_per_gas, base_fee + self.max_priority_fee_per_gas)


@dataclass
class Log:
    address: bytes
    topics: list
    data: bytes

    def rlp_item(self):
        return [self.address, list(self.topics), self.data]


@dataclass
class Receipt:
    tx_type: int
    status: int
    cumulative_gas_used: int
    logs: list

    def bloom(self) -> bytes:
        return logs_bloom(self.logs)

    def encode(self) -> bytes:
        payload = rlp.encode(
            [
                self.status,
                self.cumulative_gas_used,
                self.bloom(),
                [lg.rlp_item() for lg in self.logs],
            ]
        )
        if self.tx_type == 0:
            return payload
        return bytes([self.tx_type]) + payload


def logs_bloom(logs: list) -> bytes:
    bloom = bytearray(256)
    for lg in logs:
        for item in [lg.address] + list(lg.topics):
            h = keccak256(item)
            for i in range(0, 6, 2):
                bit = ((h[i] << 8) | h[i + 1]) & 0x7FF
                bloom[256 - 1 - bit // 8] |= 1 << (bit % 8)
    return bytes(bloom)


def combine_blooms(blooms: list[bytes]) -> bytes:
    out = bytearray(256)
    for b in blooms:
        for i in range(256):
            out[i] |= b[i]
    return bytes(out)


@dataclass
class Withdrawal:
    index: int
    validator_index: int
    address: bytes
    amount: int

    def rlp_item(self):
        return [self.index, self.validator_index, self.address, self.amount]


@dataclass
class Account:
    nonce: int = 0
    balance: int = 0
    storage_root: bytes = b""
    code_hash: bytes = KECCAK_EMPTY

    def encode(self) -> bytes:
        from ..mpt import EMPTY_ROOT

        return rlp.encode(
            [
                self.nonce,
                self.balance,
                self.storage_root or EMPTY_ROOT,
                self.code_hash,
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "Account":
        items = rlp.decode(data)
        return cls(
            nonce=rlp.decode_int(items[0]),
            balance=rlp.decode_int(items[1]),
            storage_root=items[2],
            code_hash=items[3],
        )
