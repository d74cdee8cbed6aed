"""alt_bn128 (BN254) curve ops + optimal ate pairing for EVM precompiles
0x06/0x07/0x08.

Same tower/pairing structure as raiko_tpu.kzg.host_curve but for the BN
family: Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3-(u+9)), Fp12 = Fp6[w]/(w^2-v).
The optimal ate loop runs over 6x+2 in NAF form with the two frobenius
line steps (BN-specific).  Host-side, exact; used only inside EVM
re-execution."""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
X_PARAM = 4965661367192848881
ATE_LOOP = 6 * X_PARAM + 2

G1_GEN = (1, 2)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 3) % P == 0


def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == b[0] and (a[1] + b[1]) % P == 0:
        return None
    if a == b:
        lam = 3 * a[0] * a[0] * pow(2 * a[1], -1, P) % P
    elif a[0] == b[0]:
        return None
    else:
        lam = (b[1] - a[1]) * pow(b[0] - a[0], -1, P) % P
    x = (lam * lam - a[0] - b[0]) % P
    return (x, (lam * (a[0] - x) - a[1]) % P)


def g1_mul(a, k: int):
    result = None
    k %= R
    while k:
        if k & 1:
            result = g1_add(result, a)
        a = g1_add(a, a)
        k >>= 1
    return result


def g1_neg(a):
    return None if a is None else (a[0], (-a[1]) % P)


# ---------------------------------------------------------------- towers --


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def f2_sq(a):
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def f2_muls(a, k):
    return (a[0] * k % P, a[1] * k % P)


def f2_inv(a):
    n = pow(a[0] * a[0] + a[1] * a[1], -1, P)
    return (a[0] * n % P, (-a[1]) * n % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # v^3 = u + 9


def _mul_xi(a):
    return f2_mul(a, XI)


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


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
    vt1 = (_mul_xi(t1[2]), t1[0], t1[1])
    return (
        f6_add(t0, vt1),
        f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1)),
    )


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
    while e:
        if e & 1:
            result = f12_mul(result, a)
        a = f12_sq(a)
        e >>= 1
    return result


# ---------------------------------------------------------------- G2 ------

B2 = f2_mul((3, 0), f2_inv(XI))  # twist curve: y^2 = x^3 + 3/(u+9)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_sq(y), f2_add(f2_mul(f2_sq(x), x), B2)) == F2_ZERO


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
    result = None
    k %= R
    while k:
        if k & 1:
            result = g2_add(result, a)
        a = g2_add(a, a)
        k >>= 1
    return result


def g2_in_subgroup(pt) -> bool:
    return pt is None or (g2_is_on_curve(pt) and g2_mul(pt, R) is None)


# ------------------------------------------------------------- pairing ----
# BN254 uses a D-type twist: untwist (x', y') -> (x' * w^2, y' * w^3).
# Line through twist points evaluated at P = (xp, yp) in G1:
#   l(P) = yp - lam*xp*w + (lam*x' - y')*w^3
# Multiply by nothing: coefficients land on w^0 (Fp), w^1, w^3.

_FROB_C1 = pow((P * P - 1) // 6, 1, P)  # placeholder; computed below


def _frobenius_g2(q):
    """pi(Q) = (x^p * gamma12, y^p * gamma13) on the twist."""
    x, y = q
    xq = f2_conj(x)
    yq = f2_conj(y)
    g12 = _gamma(2)
    g13 = _gamma(3)
    return (f2_mul(xq, g12), f2_mul(yq, g13))


_gamma_cache = {}


def _gamma(exp: int):
    """xi^((p-1)*exp/6) in Fp2."""
    key = exp
    if key not in _gamma_cache:
        _gamma_cache[key] = _f2_pow(XI, (P - 1) * exp // 6)
    return _gamma_cache[key]


def _f2_pow(a, e: int):
    result = F2_ONE
    while e:
        if e & 1:
            result = f2_mul(result, a)
        a = f2_sq(a)
        e >>= 1
    return result


def _line(lam, q, p):
    """Sparse Fp12 for line with Fp2 slope lam through twist point q,
    evaluated at G1 point p = (xp, yp)."""
    x, y = q
    xp, yp = p
    c = f2_sub(f2_mul(lam, x), y)
    # w^0: yp ; w^1: -lam*xp ; w^3: c
    c0 = ((yp % P, 0), F2_ZERO, F2_ZERO)
    c1 = (f2_neg(f2_muls(lam, xp)), c, F2_ZERO)
    # mapping: w^1 -> c1 coeff v^0 ; w^3 = v*w -> c1 coeff v^1
    return (c0, c1)


def _dbl_step(q, p):
    x, y = q
    lam = f2_mul(f2_muls(f2_sq(x), 3), f2_inv(f2_muls(y, 2)))
    x3 = f2_sub(f2_sq(lam), f2_muls(x, 2))
    y3 = f2_sub(f2_mul(lam, f2_sub(x, x3)), y)
    return _line(lam, q, p), (x3, y3)


def _add_step(t, q, p):
    lam = f2_mul(f2_sub(q[1], t[1]), f2_inv(f2_sub(q[0], t[0])))
    x3 = f2_sub(f2_sub(f2_sq(lam), t[0]), q[0])
    y3 = f2_sub(f2_mul(lam, f2_sub(t[0], x3)), t[1])
    return _line(lam, t, p), (x3, y3)


def miller_loop(p, q):
    if p is None or q is None:
        return F12_ONE
    f = F12_ONE
    t = q
    for bit in bin(ATE_LOOP)[3:]:
        f = f12_sq(f)
        line, t = _dbl_step(t, p)
        f = f12_mul(f, line)
        if bit == "1":
            line, t = _add_step(t, q, p)
            f = f12_mul(f, line)
    # frobenius steps (BN specific)
    q1 = _frobenius_g2(q)
    q2 = g2_neg(_frobenius_g2(_frobenius_g2(q)))
    line, t = _add_step(t, q1, p)
    f = f12_mul(f, line)
    line, t = _add_step(t, q2, p)
    f = f12_mul(f, line)
    return f


def final_exponentiation(f):
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_pow(f, P * P), f)
    hard = (P**4 - P**2 + 1) // R
    return f12_pow(f, hard)


def pairing_check(pairs) -> bool:
    f = F12_ONE
    for p, q in pairs:
        f = f12_mul(f, miller_loop(p, q))
    return final_exponentiation(f) == F12_ONE
