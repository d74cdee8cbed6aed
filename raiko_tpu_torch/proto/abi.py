"""Minimal Solidity ABI encoder/decoder.

Covers what the protocol-instance path needs (reference lib/src/
protocol_instance.rs + the sol! types in input.rs): static types (uintN,
address, bytes32, bool, static structs/tuples), dynamic string/bytes,
and dynamic arrays/structs — standard head/tail encoding.

Types are described by simple spec strings / tuples:
  "uint64" | "uint256" | "address" | "bytes32" | "bool" | "string" |
  "bytes" | ("tuple", [specs...]) | ("array", spec)
"""

from __future__ import annotations


def _is_dynamic(spec) -> bool:
    if isinstance(spec, tuple):
        kind = spec[0]
        if kind == "array":
            return True
        if kind == "tuple":
            return any(_is_dynamic(s) for s in spec[1])
        raise ValueError(spec)
    return spec in ("string", "bytes")


def _enc_static(spec, value) -> bytes:
    if isinstance(spec, tuple) and spec[0] == "tuple":
        return b"".join(_enc_static(s, v) for s, v in zip(spec[1], value))
    if spec.startswith("uint") or spec.startswith("int"):
        return int(value).to_bytes(32, "big", signed=spec.startswith("int"))
    if spec == "address":
        v = bytes.fromhex(value[2:]) if isinstance(value, str) else bytes(value)
        return v.rjust(32, b"\x00")
    if spec == "bytes32":
        v = bytes(value)
        assert len(v) == 32
        return v
    if spec == "bool":
        return (1 if value else 0).to_bytes(32, "big")
    raise ValueError(f"not a static type: {spec}")


def encode(specs: list, values: list) -> bytes:
    """abi.encode(values) with the given type specs (head/tail layout)."""
    heads = []
    tails = []
    head_len = sum(
        32 if _is_dynamic(s) else len(_enc_static(s, v))
        for s, v in zip(specs, values)
    )
    offset = head_len
    for spec, value in zip(specs, values):
        if _is_dynamic(spec):
            tail = _enc_dynamic(spec, value)
            heads.append(offset.to_bytes(32, "big"))
            tails.append(tail)
            offset += len(tail)
        else:
            heads.append(_enc_static(spec, value))
    return b"".join(heads) + b"".join(tails)


def _enc_dynamic(spec, value) -> bytes:
    if spec in ("string", "bytes"):
        data = value.encode() if isinstance(value, str) else bytes(value)
        padded = data.ljust((len(data) + 31) // 32 * 32, b"\x00")
        return len(data).to_bytes(32, "big") + padded
    if isinstance(spec, tuple) and spec[0] == "array":
        inner = spec[1]
        body = encode([inner] * len(value), list(value))
        return len(value).to_bytes(32, "big") + body
    if isinstance(spec, tuple) and spec[0] == "tuple":
        return encode(spec[1], list(value))
    raise ValueError(spec)


def decode(specs: list, data: bytes) -> list:
    out, _ = _dec_seq(specs, data, 0)
    return out


def _dec_seq(specs, data, base):
    values = []
    pos = base
    for spec in specs:
        if _is_dynamic(spec):
            off = int.from_bytes(data[pos : pos + 32], "big")
            values.append(_dec_dynamic(spec, data, base + off))
            pos += 32
        else:
            v, pos = _dec_static(spec, data, pos)
            values.append(v)
    return values, pos


def _dec_static(spec, data, pos):
    if isinstance(spec, tuple) and spec[0] == "tuple":
        return _dec_seq(spec[1], data, pos)[0], pos + _static_size(spec)
    word = data[pos : pos + 32]
    if spec.startswith("uint"):
        return int.from_bytes(word, "big"), pos + 32
    if spec.startswith("int"):
        return int.from_bytes(word, "big", signed=True), pos + 32
    if spec == "address":
        return word[12:], pos + 32
    if spec == "bytes32":
        return word, pos + 32
    if spec == "bool":
        return word[-1] == 1, pos + 32
    raise ValueError(spec)


def _static_size(spec) -> int:
    if isinstance(spec, tuple) and spec[0] == "tuple":
        return sum(_static_size(s) for s in spec[1])
    return 32


def _dec_dynamic(spec, data, pos):
    if spec in ("string", "bytes"):
        n = int.from_bytes(data[pos : pos + 32], "big")
        raw = data[pos + 32 : pos + 32 + n]
        return raw.decode() if spec == "string" else raw
    if isinstance(spec, tuple) and spec[0] == "array":
        n = int.from_bytes(data[pos : pos + 32], "big")
        return _dec_seq([spec[1]] * n, data, pos + 32)[0]
    if isinstance(spec, tuple) and spec[0] == "tuple":
        return _dec_seq(spec[1], data, pos)[0]
    raise ValueError(spec)
