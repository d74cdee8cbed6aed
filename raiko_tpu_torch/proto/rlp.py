"""RLP (recursive length prefix) encoding/decoding — Ethereum wire format.

Byte-exact with the spec; exercised against known header/tx hashes in
tests.  Items are bytes or (nested) lists of items; ints are encoded
big-endian minimal (helper ``encode_int``)."""

from __future__ import annotations


class Raw(bytes):
    """Pre-encoded RLP spliced verbatim (used for inline trie node refs)."""


def encode(item) -> bytes:
    if isinstance(item, Raw):
        return bytes(item)
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _len_prefix(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _len_prefix(len(payload), 0xC0) + payload
    if isinstance(item, int):
        return encode(encode_int_bytes(item))
    raise TypeError(f"cannot RLP-encode {type(item)}")


def encode_int_bytes(v: int) -> bytes:
    if v == 0:
        return b""
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


def _len_prefix(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    lb = encode_int_bytes(length)
    return bytes([offset + 55 + len(lb)]) + lb


class DecodeError(ValueError):
    pass


def decode(data: bytes):
    """Decode one item; error on trailing bytes."""
    item, rest = _decode_one(memoryview(data))
    if len(rest) != 0:
        raise DecodeError("trailing bytes")
    return item


def _decode_one(data):
    if len(data) == 0:
        raise DecodeError("empty input")
    b0 = data[0]
    if b0 < 0x80:
        return bytes(data[:1]), data[1:]
    if b0 < 0xB8:  # short string
        n = b0 - 0x80
        if len(data) < 1 + n:
            raise DecodeError("short string truncated")
        if n == 1 and data[1] < 0x80:
            raise DecodeError("non-canonical single byte")
        return bytes(data[1 : 1 + n]), data[1 + n :]
    if b0 < 0xC0:  # long string
        ln = b0 - 0xB7
        n = int.from_bytes(bytes(data[1 : 1 + ln]), "big")
        if ln > 1 and data[1] == 0 or n < 56:
            raise DecodeError("non-canonical length")
        if len(data) < 1 + ln + n:
            raise DecodeError("long string truncated")
        return bytes(data[1 + ln : 1 + ln + n]), data[1 + ln + n :]
    if b0 < 0xF8:  # short list
        n = b0 - 0xC0
        if len(data) < 1 + n:
            raise DecodeError("short list truncated")
        return _decode_list(data[1 : 1 + n]), data[1 + n :]
    ln = b0 - 0xF7
    n = int.from_bytes(bytes(data[1 : 1 + ln]), "big")
    if ln > 1 and data[1] == 0 or n < 56:
        raise DecodeError("non-canonical length")
    if len(data) < 1 + ln + n:
        raise DecodeError("list truncated")
    return _decode_list(data[1 + ln : 1 + ln + n]), data[1 + ln + n :]


def _decode_list(data):
    out = []
    while len(data):
        item, data = _decode_one(data)
        out.append(item)
    return out


def decode_int(b: bytes) -> int:
    if len(b) > 0 and b[0] == 0:
        raise DecodeError("leading zero in integer")
    return int.from_bytes(b, "big")
