"""Tx-list codec: op-stack blob encoding + zlib compression.

Byte-exact reimplementation of reference lib/src/utils.rs:
``decode_blob_data`` (:85-145, the op-stack 4x6-bit field-element packing;
4096 x 32B blob -> <=130044B data), ``zlib_(de)compress_data`` (:181-193),
``get_tx_list`` policy per chain (:27-56) and transaction list decoding
with anchor-tx prepend (:58-73).  An encoder (``encode_blob_data``) is
provided for constructing test blobs — the inverse the reference gets from
taiko-client."""

from __future__ import annotations

import zlib

from ..proto import rlp
from ..proto.types import Transaction

BLOB_FIELD_ELEMENT_NUM = 4096
BLOB_FIELD_ELEMENT_BYTES = 32
BLOB_DATA_CAPACITY = BLOB_FIELD_ELEMENT_NUM * BLOB_FIELD_ELEMENT_BYTES
CALL_DATA_CAPACITY = BLOB_FIELD_ELEMENT_NUM * (BLOB_FIELD_ELEMENT_BYTES - 1)
BLOB_VERSION_OFFSET = 1
BLOB_ENCODING_VERSION = 0
MAX_BLOB_DATA_SIZE = (4 * 31 + 3) * 1024 - 4  # 130044


def decode_blob_data(blob: bytes) -> bytes:
    """Reference decode_blob_data (:85-145); returns b'' on any
    malformation, like the reference returns Vec::new()."""
    if len(blob) < 32:
        return b""
    if blob[BLOB_VERSION_OFFSET] != BLOB_ENCODING_VERSION:
        return b""
    output_len = (blob[2] << 16) | (blob[3] << 8) | blob[4]
    if output_len > MAX_BLOB_DATA_SIZE:
        return b""
    output = bytearray(MAX_BLOB_DATA_SIZE)
    output[0:27] = blob[5:32]
    opos = 28
    ipos = 32
    encoded = [blob[0], 0, 0, 0]
    for i in range(1, 4):
        res = _decode_field_element(blob, opos, ipos, output)
        if res is None:
            return b""
        encoded[i], opos, ipos = res
    opos = _reassemble_bytes(opos, encoded, output)
    for _ in range(1, 1024):
        if opos < output_len:
            for j in range(4):
                res = _decode_field_element(blob, opos, ipos, output)
                if res is None:
                    return b""
                encoded[j], opos, ipos = res
            opos = _reassemble_bytes(opos, encoded, output)
    if any(output[output_len:]):
        return b""
    if any(blob[ipos:BLOB_DATA_CAPACITY]):
        return b""
    return bytes(output[:output_len])


def _decode_field_element(b, opos, ipos, output):
    if ipos + 32 > len(b):
        return None
    if b[ipos] & 0b1100_0000:
        return None
    output[opos : opos + 31] = b[ipos + 1 : ipos + 32]
    return b[ipos], opos + 32, ipos + 32


def _reassemble_bytes(opos, enc, output):
    opos -= 1
    x = (enc[0] & 0b0011_1111) | ((enc[1] & 0b0011_0000) << 2)
    y = (enc[1] & 0b0000_1111) | ((enc[3] & 0b0000_1111) << 4)
    z = (enc[2] & 0b0011_1111) | ((enc[3] & 0b0011_0000) << 2)
    output[opos - 32] = z
    output[opos - 64] = y
    output[opos - 96] = x
    return opos


def _unpack_xyz(x: int, y: int, z: int) -> tuple[int, int, int, int]:
    """Invert reassemble_bytes: recover the four 6-bit bytes from x,y,z."""
    e0 = x & 0b0011_1111
    e1 = ((x >> 2) & 0b0011_0000) | (y & 0b0000_1111)
    e2 = z & 0b0011_1111
    e3 = ((z >> 2) & 0b0011_0000) | ((y >> 4) & 0b0000_1111)
    return e0, e1, e2, e3


def encode_blob_data(data: bytes) -> bytes:
    """Inverse of decode_blob_data (the op-stack blob encoder the reference
    gets from taiko-client); builds blobs the decoder round-trips exactly.

    Decoder output layout (derived from decode_blob_data index arithmetic):
    round 0 fills output[0:123] with gap bytes at 27 (x), 59 (y), 91 (z);
    each later round r starts at o = 123 + (r-1)*127 and fills 127 bytes
    with payload chunks at o, o+32, o+64, o+96 (31 bytes each) and the
    reassembled x,y,z at o+31, o+63, o+95."""
    assert len(data) <= MAX_BLOB_DATA_SIZE, "data too large for one blob"
    output_len = len(data)
    buf = bytearray(MAX_BLOB_DATA_SIZE)
    buf[:output_len] = data
    blob = bytearray(BLOB_DATA_CAPACITY)

    def put_fe(idx: int, sixbit: int, payload: bytes):
        assert sixbit & 0b1100_0000 == 0 and len(payload) == 31
        blob[32 * idx] = sixbit
        blob[32 * idx + 1 : 32 * idx + 32] = payload

    # round 0
    e0, e1, e2, e3 = _unpack_xyz(buf[27], buf[59], buf[91])
    header = bytes([BLOB_ENCODING_VERSION]) + output_len.to_bytes(3, "big")
    put_fe(0, e0, header + bytes(buf[0:27]))
    put_fe(1, e1, bytes(buf[28:59]))
    put_fe(2, e2, bytes(buf[60:91]))
    put_fe(3, e3, bytes(buf[92:123]))
    opos = 123
    fe_idx = 4
    for _ in range(1, 1024):
        if opos >= output_len:
            break
        o = opos
        e0, e1, e2, e3 = _unpack_xyz(buf[o + 31], buf[o + 63], buf[o + 95])
        put_fe(fe_idx, e0, bytes(buf[o : o + 31]))
        put_fe(fe_idx + 1, e1, bytes(buf[o + 32 : o + 63]))
        put_fe(fe_idx + 2, e2, bytes(buf[o + 64 : o + 95]))
        put_fe(fe_idx + 3, e3, bytes(buf[o + 96 : o + 127]))
        fe_idx += 4
        opos += 127
    return bytes(blob)


def zlib_compress_data(data: bytes) -> bytes:
    return zlib.compress(data)


def zlib_decompress_data(data: bytes) -> bytes:
    return zlib.decompress(data)


def get_tx_list(chain_spec, is_blob_data: bool, tx_list: bytes) -> bytes:
    """Per-chain tx-list extraction policy (reference utils.rs:27-56)."""
    if chain_spec.is_taiko:
        if is_blob_data:
            compressed = decode_blob_data(tx_list)
            return _try_decompress(compressed)
        if chain_spec.name == "taiko_a7":
            out = _try_decompress(tx_list)
            return out if len(out) <= CALL_DATA_CAPACITY else b""
        if len(tx_list) <= CALL_DATA_CAPACITY:
            return _try_decompress(tx_list)
        return b""
    return _try_decompress(tx_list)


def _try_decompress(data: bytes) -> bytes:
    try:
        return zlib.decompress(data)
    except zlib.error:
        return b""


def decode_transactions(tx_list: bytes) -> list[Transaction]:
    """Decode an RLP list of transactions (legacy = structure, typed =
    byte-string envelope); malformed lists decode to [] like the
    reference."""
    try:
        items = rlp.decode(tx_list)
        if not isinstance(items, list):
            return []
        out = []
        for item in items:
            if isinstance(item, bytes):
                out.append(Transaction.decode(item))
            else:
                out.append(Transaction.decode(rlp.encode(item)))
        return out
    except Exception:
        return []


def encode_transactions(txs: list[Transaction]) -> bytes:
    items = []
    for tx in txs:
        enc = tx.encode()
        if tx.tx_type == 0:
            items.append(rlp.Raw(enc))
        else:
            items.append(enc)
    return rlp.encode(items)


def generate_transactions(
    chain_spec, is_blob_data: bool, tx_list: bytes, anchor_tx=None
) -> list[Transaction]:
    """Reference generate_transactions (:58-73): decode the on-chain tx
    list and prepend the anchor tx."""
    raw = get_tx_list(chain_spec, is_blob_data, tx_list)
    txs = decode_transactions(raw)
    if anchor_tx is not None:
        txs.insert(0, anchor_tx)
    return txs
