"""Batched secp256k1 ECDSA recovery on torch tensors.

Port of raiko_tpu/ops/secp.py.  secp256k1 is an a = 0 curve like BLS12-381
G1, so the same complete RCB15 formulas apply with b3 = 3·7 = 21 over a
16-limb (256-bit) Montgomery field; points are (..., 3, 16) int64 tensors.

Recovery per lane (Q = r^{-1}(s·R - e·G)):
  host: decompress R from (r, rec_id), u1 = s·r^{-1} mod n, u2 = e·r^{-1} mod n;
  device: Q = u1·R + u2·(-G) for all lanes in one launch of the Shamir
        ladder (ops/secp_cuda.py, kernel B4), which also completes the
        window table [∞, R, -G, R-G];
  host: affine conversion; the caller hashes to an address.

Invalid signatures are found on the host and their lanes dropped; callers
get None back for them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..fields.limbs import LimbField
from ..utils import secp256k1 as host
from ..utils.native import keccak256
from . import secp_cuda

NLIMBS = 16
FP = LimbField(host.P, NLIMBS)


# -- point helpers (mirrors kzg/curve.py at 16 limbs) -------------------------


def identity(shape=(), device="cpu") -> torch.Tensor:
    z = torch.zeros((3, NLIMBS), dtype=torch.int64, device=device)
    z[1] = FP.const("r", device)
    return z.expand(tuple(shape) + (3, NLIMBS))


def make_point(x_int: int, y_int: int) -> np.ndarray:
    return np.stack([FP.to_mont_int(x_int), FP.to_mont_int(y_int), FP.to_mont_int(1)])


def to_affine(pt) -> tuple[int, int] | None:
    pt = np.asarray(pt.cpu() if isinstance(pt, torch.Tensor) else pt)
    x = FP.from_mont_limbs(pt[0])
    y = FP.from_mont_limbs(pt[1])
    z = FP.from_mont_limbs(pt[2])
    if z == 0:
        return None
    zinv = pow(z, -1, host.P)
    return (x * zinv % host.P, y * zinv % host.P)


def _stk(*xs):
    return torch.stack(xs, dim=-2)


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete projective addition (RCB15 Alg. 7, a=0, b3=21); same
    two-layer batched-mul structure as kzg/curve.add."""
    X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    X2, Y2, Z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    sA = FP.add(_stk(X1, X2, Y1, Y2, X1, X2), _stk(Y1, Y2, Z1, Z2, Z1, Z2))
    m1 = FP.mont_mul(
        _stk(X1, Y1, Z1, sA[..., 0, :], sA[..., 2, :], sA[..., 4, :]),
        _stk(X2, Y2, Z2, sA[..., 1, :], sA[..., 3, :], sA[..., 5, :]),
    )
    t0, t1, t2 = m1[..., 0, :], m1[..., 1, :], m1[..., 2, :]
    s1, s2, s3 = m1[..., 3, :], m1[..., 4, :], m1[..., 5, :]
    u = FP.add(_stk(t0, t1, t0), _stk(t1, t2, t2))
    v = FP.sub(_stk(s1, s2, s3), u)
    t3, t4, y3a = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    # constant chains: 3*t0, 21*t2, 21*y3a (21x = 24x - 3x)
    x1s = _stk(t0, t2, y3a)
    x2s = FP.add(x1s, x1s)  # 2x
    x3s = FP.add(x2s, x1s)  # 3x  (3t0 ready)
    pair3 = x3s[..., 1:3, :]
    x6 = FP.add(pair3, pair3)
    x12 = FP.add(x6, x6)
    x24 = FP.add(x12, x12)
    x21 = FP.sub(x24, pair3)
    t0b = x3s[..., 0, :]
    t2b = x21[..., 0, :]
    y3b = x21[..., 1, :]
    z3a = FP.add(t1, t2b)
    t1b = FP.sub(t1, t2b)
    m2 = FP.mont_mul(
        _stk(t4, t3, y3b, t1b, t0b, z3a),
        _stk(y3b, t1b, t0b, z3a, t3, t4),
    )
    X3 = FP.sub(m2[..., 1, :], m2[..., 0, :])
    yz = FP.add(_stk(m2[..., 3, :], m2[..., 5, :]), _stk(m2[..., 2, :], m2[..., 4, :]))
    return _stk(X3, yz[..., 0, :], yz[..., 1, :])


def double(p: torch.Tensor) -> torch.Tensor:
    """Complete projective doubling (RCB15 Alg. 9, a=0, b3=21)."""
    X, Y, Z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    m1 = FP.mont_mul(_stk(Y, Y, Z, X), _stk(Y, Z, Z, Y))
    t0, t1, t2, txy = (m1[..., i, :] for i in range(4))
    z3 = FP.add(t0, t0)
    z3 = FP.add(z3, z3)
    z3 = FP.add(z3, z3)  # 8*Y^2
    # t2b = 21*t2 = 16x + 4x + x
    x2 = FP.add(t2, t2)
    x4 = FP.add(x2, x2)
    x8 = FP.add(x4, x4)
    x16 = FP.add(x8, x8)
    t2b = FP.add(FP.add(x16, x4), t2)
    y3a = FP.add(t0, t2b)
    t2x3 = FP.add(FP.add(t2b, t2b), t2b)
    t0b = FP.sub(t0, t2x3)
    m2 = FP.mont_mul(_stk(t2b, t1, t0b, t0b), _stk(z3, z3, y3a, txy))
    X3 = FP.add(m2[..., 3, :], m2[..., 3, :])
    Y3 = FP.add(m2[..., 0, :], m2[..., 2, :])
    Z3 = m2[..., 1, :]
    return _stk(X3, Y3, Z3)


# -- Shamir double-scalar ladder ----------------------------------------------


def _shamir(table: torch.Tensor, bits1: torch.Tensor, bits2: torch.Tensor) -> torch.Tensor:
    """Per lane u1*T1 + u2*T2 with table = [∞, T1, T2, T1+T2].

    table: (B, 4, 3, 16); bits1/bits2: (256, B), MSB first.  256 iterations;
    each is one batched double and one batched complete add."""
    bsz = table.shape[0]
    lanes = torch.arange(bsz, device=table.device)
    acc = identity((bsz,), table.device)
    for k in range(256):
        acc = double(acc)
        idx = bits1[k] + 2 * bits2[k]  # (B,) in 0..3
        acc = add(acc, table[lanes, idx])
    return acc


def _bits_msb(vals: list[int]) -> np.ndarray:
    """(256, B) uint32, out[k, b] = bit (255-k) of vals[b]."""
    buf = b"".join(v.to_bytes(32, "big") for v in vals)
    bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8))
    return bits.reshape(len(vals), 256).T.astype(np.uint32)


_NEG_G = (host.GX, host.P - host.GY)


def ladder_inputs(items: list[tuple[bytes, int, int, int]]):
    """Host half of recovery: (msg_hash, r, s, rec_id) items -> (lanes,
    base, idx).  ``lanes`` holds None for each invalid signature; the live
    lanes, in order, have base points [R, -G] in ``base`` (L, 2, 3, 16)
    int64 and the ladder's window indices in ``idx`` (256, L) int32."""
    n = host.N
    lanes: list[dict | None] = []
    for msg_hash, r, s, rec_id in items:
        if not (1 <= r < n and 1 <= s < n) or rec_id not in (0, 1, 2, 3):
            lanes.append(None)
            continue
        x = r + (n if rec_id >= 2 else 0)
        if x >= host.P:
            lanes.append(None)
            continue
        y2 = (pow(x, 3, host.P) + 7) % host.P
        y = pow(y2, (host.P + 1) // 4, host.P)
        if y * y % host.P != y2:
            lanes.append(None)
            continue
        if (y & 1) != (rec_id & 1):
            y = host.P - y
        e = int.from_bytes(msg_hash, "big") % n
        r_inv = pow(r, -1, n)
        lanes.append({"R": (x, y), "u1": s * r_inv % n, "u2": e * r_inv % n})
    live = [ln for ln in lanes if ln is not None]
    base = np.empty((len(live), 2, 3, NLIMBS), dtype=np.int64)
    base[:, 1] = make_point(*_NEG_G)
    for i, ln in enumerate(live):
        base[i, 0] = make_point(*ln["R"])
    idx = _bits_msb([ln["u1"] for ln in live]) + 2 * _bits_msb([ln["u2"] for ln in live])
    return lanes, base, np.ascontiguousarray(idx.reshape(256, len(live)), dtype=np.int32)


def recover_pubkeys_batch(
    items: list[tuple[bytes, int, int, int]], device
) -> list[tuple[int, int] | None]:
    """Batch of (msg_hash, r, s, rec_id) -> public-key points (or None).

    Exact drop-in for [host.recover_pubkey(*it) for it in items], with all
    the curve arithmetic in one launch on `device`."""
    lanes, base, idx = ladder_inputs(items)
    if not base.shape[0]:
        return [None] * len(lanes)
    q = secp_cuda.shamir_ladder(
        convert.pack32(torch.as_tensor(base, device=device)),
        torch.as_tensor(idx, device=device),
    )
    q = convert.unpack32(q).cpu().numpy()
    out: list[tuple[int, int] | None] = []
    li = 0
    for ln in lanes:
        if ln is None:
            out.append(None)
        else:
            out.append(to_affine(q[li]))
            li += 1
    return out


def recover_senders(txs, device) -> list:
    """Every tx's sender from one batched recovery on `device`.

    Returns a list aligned with txs whose entries are 20-byte addresses or
    the ValueError to raise at that tx's slot: the contract of
    evm/execute.py:_batch_recover_senders past its size and policy checks."""
    items = []
    slots: list = [None] * len(txs)
    idxs = []
    for i, tx in enumerate(txs):
        try:
            msg_hash, rec_id = tx.signature_parts()
        except ValueError as exc:
            slots[i] = exc
            continue
        items.append((msg_hash, tx.r, tx.s, rec_id))
        idxs.append(i)
    if items:
        pubs = recover_pubkeys_batch(items, device)
        for i, q in zip(idxs, pubs):
            if q is None:
                slots[i] = ValueError("signature recovery failed")
            else:
                slots[i] = keccak256(q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big"))[12:]
    return slots


def use_device_recovery(device) -> bool:
    """Policy: batch recovery on the card.  On the CPU the per-tx host path
    is cheaper than the plain ladder at block sizes."""
    return torch.device(device).type == "cuda"
