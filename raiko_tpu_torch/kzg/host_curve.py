"""BLS12-381 host-side reference arithmetic (pure Python ints).

Role: the *verifier* side of the KZG path — pairing checks, point
serialization, and golden cross-checks for the TPU kernels.  Proving-side
throughput work (the 4096-point MSM) runs on TPU (ops/msm.py); this module
is deliberately simple and exact, mirroring how the reference keeps
verification in plain code while proving is accelerated
(lib/src/primitives/eip4844.rs + vendored blst, SURVEY.md §2.2).

Implements: Fp/Fp2/Fp6/Fp12 towers, G1/G2 Jacobian arithmetic, compressed
serialization (ZCash flags), subgroup checks, and the optimal ate pairing
(Miller loop + final exponentiation) for BLS12-381.
"""

from __future__ import annotations

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative); |x| drives the Miller loop and final exp
BLS_X = 0xD201000000010000
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# ------------------------------------------------------------------ G1 ----


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 4) % P == 0


def g1_add(a, b):
    """Affine addition (None = infinity).  Exact, host-side."""
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == b[0]:
        if (a[1] + b[1]) % P == 0:
            return None
        lam = 3 * a[0] * a[0] * pow(2 * a[1], -1, P) % P
    else:
        lam = (b[1] - a[1]) * pow(b[0] - a[0], -1, P) % P
    x3 = (lam * lam - a[0] - b[0]) % P
    return (x3, (lam * (a[0] - x3) - a[1]) % P)


def g1_neg(a):
    return None if a is None else (a[0], (-a[1]) % P)


def g1_mul(a, k: int):
    k %= R
    result = None
    addend = a
    while k:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_add(addend, addend)
        k >>= 1
    return result


def g1_msm(points, scalars):
    """Pippenger MSM over affine points (host reference; c = 8)."""
    c = 8
    nwin = (256 + c - 1) // c
    result = None
    for w in reversed(range(nwin)):
        if result is not None:
            for _ in range(c):
                result = g1_add(result, result)
        buckets: dict[int, object] = {}
        for pt, s in zip(points, scalars):
            digit = (s >> (c * w)) & ((1 << c) - 1)
            if digit and pt is not None:
                buckets[digit] = g1_add(buckets.get(digit), pt)
        running = None
        acc = None
        for b in range(max(buckets.keys(), default=0), 0, -1):
            running = g1_add(running, buckets.get(b))
            acc = g1_add(acc, running)
        result = g1_add(result, acc)
    return result


def g1_compress(pt) -> bytes:
    if pt is None:
        return bytes([0xC0] + [0] * 47)
    x, y = pt
    flag = 0x80 | (0x20 if y > (P - 1) // 2 else 0)
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= flag
    return bytes(b)


def g1_decompress(data: bytes):
    assert len(data) == 48
    flags = data[0]
    assert flags & 0x80, "only compressed points supported"
    if flags & 0x40:
        assert all(v == 0 for v in data[1:]) and flags == 0xC0
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    y2 = (x * x * x + 4) % P
    y = pow(y2, (P + 1) // 4, P)
    assert y * y % P == y2, "not a square: invalid point"
    if ((flags & 0x20) != 0) != (y > (P - 1) // 2):
        y = P - y
    return (x, y)


def g1_in_subgroup(pt) -> bool:
    return g1_mul(pt, R) is None


# --------------------------------------------------------------- towers ----
# Fp2 = Fp[u]/(u^2+1); Fp6 = Fp2[v]/(v^3-(u+1)); Fp12 = Fp6[w]/(w^2-v)


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def f2_sq(a):
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def f2_muls(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_inv(a):
    n = pow(a[0] * a[0] + a[1] * a[1], -1, P)
    return (a[0] * n % P, -a[1] * n % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


F2_ONE = (1, 0)
F2_ZERO = (0, 0)
_XI = (1, 1)  # v^3 = u + 1


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def _mul_xi(a):
    return f2_mul(a, _XI)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(t0, _mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), _mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sq(a0), _mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(_mul_xi(f2_sq(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sq(a1), f2_mul(a0, a2))
    t = f2_inv(f2_add(f2_mul(a0, c0), _mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2)))))
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    # v * t1  (multiply by w^2 = v: shift with xi on wraparound)
    vt1 = (_mul_xi(t1[2]), t1[0], t1[1])
    c0 = f6_add(t0, vt1)
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_sq(a):
    return f12_mul(a, a)


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    vsq = f6_mul(a1, a1)
    vsq = (_mul_xi(vsq[2]), vsq[0], vsq[1])
    t = f6_inv(f6_sub(f6_mul(a0, a0), vsq))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


F12_ONE = (F6_ONE, F6_ZERO)


def f12_pow(a, e: int):
    result = F12_ONE
    base = a
    while e:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_sq(base)
        e >>= 1
    return result


# ------------------------------------------------------------------ G2 ----


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    b2 = (4, 4)
    return f2_sub(f2_sq(y), f2_add(f2_mul(f2_sq(x), x), b2)) == F2_ZERO


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == b[0]:
        if f2_add(a[1], b[1]) == F2_ZERO:
            return None
        lam = f2_mul(f2_muls(f2_sq(a[0]), 3), f2_inv(f2_muls(a[1], 2)))
    else:
        lam = f2_mul(f2_sub(b[1], a[1]), f2_inv(f2_sub(b[0], a[0])))
    x3 = f2_sub(f2_sub(f2_sq(lam), a[0]), b[0])
    return (x3, f2_sub(f2_mul(lam, f2_sub(a[0], x3)), a[1]))


def g2_neg(a):
    return None if a is None else (a[0], f2_neg(a[1]))


def g2_mul(a, k: int):
    k %= R
    result = None
    addend = a
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result


# -------------------------------------------------------------- pairing ----


def _line_double(q, p):
    """Line through 2*[q], evaluated at affine G1 point p. Returns
    (f12 line value, doubled point).  q affine over Fp2."""
    x, y = q
    lam = f2_mul(f2_muls(f2_sq(x), 3), f2_inv(f2_muls(y, 2)))
    x3 = f2_sub(f2_sq(lam), f2_muls(x, 2))
    y3 = f2_sub(f2_mul(lam, f2_sub(x, x3)), y)
    # l(P) = lam * x_p - y_p * 1 - (lam*x - y); embed via sparse Fp12
    return _line_eval(lam, f2_sub(f2_mul(lam, x), y), p), (x3, y3)


def _line_add(q1, q2, p):
    x1, y1 = q1
    x2, y2 = q2
    lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sq(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return _line_eval(lam, f2_sub(f2_mul(lam, x1), y1), p), (x3, y3)


def _line_eval(lam, c, p):
    """Evaluate the tangent/chord line at the G1 point P, mapped into Fp12.

    BLS12-381's G2 lives on the M-twist y^2 = x^3 + 4(u+1); the untwist is
    (x', y') -> (x'/w^2, y'/w^3) with w^2 = v, v^3 = u+1.  For a line with
    Fp2 slope ``lam`` through twist point (x', y') and ``c = lam*x' - y'``,
    the line value at P = (xp, yp) is

        l(P) = yp - lam*xp*w^{-1} + c*w^{-3}

    Scaling by (u+1) in Fp2 (killed by the final exponentiation, since
    Fp2* has order dividing (p^2-1) | (p^12-1)/r) clears denominators:

        l'(P) = yp*(u+1)  +  c * w^3  +  (-lam*xp) * w^5

    mapped onto the Fp6[w] basis (w^3 = v*w, w^5 = v^2*w)."""
    xp, yp = p
    c0 = ((yp % P, yp % P), F2_ZERO, F2_ZERO)
    c1 = (F2_ZERO, c, f2_neg(f2_muls(lam, xp)))
    return (c0, c1)


def miller_loop(p, q):
    """Optimal ate Miller loop for BLS12-381: f_{|x|, Q}(P), then conjugate
    (x < 0)."""
    if p is None or q is None:
        return F12_ONE
    f = F12_ONE
    t = q
    for bit in bin(BLS_X)[3:]:
        f = f12_sq(f)
        line, t = _line_double(t, p)
        f = f12_mul(f, line)
        if bit == "1":
            line, t = _line_add(t, q, p)
            f = f12_mul(f, line)
    return f12_conj(f)  # x is negative


def final_exponentiation(f):
    """f^((p^12-1)/r).  Easy part algebraically; hard part by plain
    exponentiation (host-side verification only, seconds not micros)."""
    # easy part: f^(p^6-1) = conj(f) * f^-1 ; then ^(p^2+1)
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_pow(f, P * P), f)
    # hard part
    hard = (P**4 - P**2 + 1) // R
    return f12_pow(f, hard)


def pairing(p, q) -> tuple:
    """e(P in G1, Q in G2) in Fp12."""
    return final_exponentiation(miller_loop(p, q))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1, with a single final exponentiation."""
    f = F12_ONE
    for p, q in pairs:
        f = f12_mul(f, miller_loop(p, q))
    return final_exponentiation(f) == F12_ONE
