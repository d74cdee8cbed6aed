"""Multi-limb Montgomery field arithmetic on int64 tensors of 16-bit limbs.

Port of raiko_tpu/fields/limbs.py.  A field element is a (..., NLIMBS)
tensor of 16-bit limbs, little-endian, with the reference's Montgomery
radix R = 2^(16·NLIMBS), so Montgomery values agree bit for bit.  Every
operation returns canonical limbs (value < p): results are unique, and
equal the reference's whatever the order of the internal carries.

This is the plain PyTorch arithmetic that the CUDA kernels are held
against, and what runs on a CPU tensor.  Its cost is the number of torch
ops (each a kernel launch), so it is written for few ops per field
operation:

* Limbs live in int64, because torch's uint32 has no add, shift or compare
  on the CPU.  The headroom lets column sums of whole 32-bit partial
  products accumulate without splitting.
* Carry and borrow chains resolve in one integer addition: with per-limb
  generate bits G and propagate bits P packed into one integer each,
  ((G + P) + G) ^ (G + P) ^ G has the carry into limb i at bit i.
* The Montgomery product is the full-width form: T = a·b,
  m = (T mod R)·(-p^-1) mod R, (T + m·p) / R, as three column products
  instead of n sequential reduction steps.  The two by constants are exact
  float64 matrix products.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MASK16 = 0xFFFF


def int_to_limbs(v: int, nlimbs: int) -> np.ndarray:
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(nlimbs)], dtype=np.uint32)


def limbs_to_int(a) -> int:
    a = np.asarray(a)
    return sum(int(x) << (16 * i) for i, x in enumerate(a.tolist()))


def _toeplitz(limbs: np.ndarray, ncols: int) -> np.ndarray:
    """(n, ncols) matrix with row i holding `limbs` from column i, so that
    x @ T is the column product of x with `limbs`, cut at ncols columns."""
    n = len(limbs)
    t = np.zeros((n, ncols), dtype=np.int64)
    for i in range(n):
        w = min(n, ncols - i)
        if w > 0:
            t[i, i : i + w] = limbs[:w]
    return t


def _columns(x: torch.Tensor, toep: torch.Tensor) -> torch.Tensor:
    """Column product of (..., n) 16-bit limbs with a constant given as a
    float64 Toeplitz matrix of 16-bit limbs.  One float64 matrix product:
    the terms are < 2^32 and the sums < n·2^32 < 2^53, so it is exact."""
    return (x.double() @ toep).long()


def _product_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column product of two (..., n) limb tensors -> (..., 2n-1) columns:
    out_k = Σ_i a_i b_{k-i}, taken as Σ_j a_{n-1-j} · bp_{k+j} over a
    Hankel view of b padded with n-1 zeros on each side (no copy)."""
    n = a.shape[-1]
    bp = F.pad(b, (n - 1, n - 1)).contiguous()
    lead = bp.shape[:-1]
    rows = bp.reshape(-1, 3 * n - 2)
    hankel = rows.as_strided((rows.shape[0], n, 2 * n - 1), (3 * n - 2, 1, 1))
    arev = a.flip(-1).reshape(-1, n, 1)
    return (arev * hankel).sum(dim=-2).reshape(lead + (2 * n - 1,))


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """x[i] <- x[i-1] along the limb axis; limb 0 gets 0."""
    return F.pad(x[..., :-1], (1, 0))


class LimbField:
    """A prime field with elements as (..., nlimbs) int64 tensors of 16-bit limbs."""

    def __init__(self, modulus: int, nlimbs: int):
        assert modulus < (1 << (16 * nlimbs))
        self.modulus = modulus
        self.nlimbs = nlimbs
        self.R = (1 << (16 * nlimbs)) % modulus
        self.R2 = (self.R * self.R) % modulus
        self.p_limbs = int_to_limbs(modulus, nlimbs)
        self.r_limbs = int_to_limbs(self.R, nlimbs)
        self.r2_limbs = int_to_limbs(self.R2, nlimbs)
        nprime_full = (-pow(modulus, -1, 1 << (16 * nlimbs))) % (1 << (16 * nlimbs))
        one = np.zeros(nlimbs, dtype=np.int64)
        one[0] = 1
        self._host_consts = {
            "p": self.p_limbs.astype(np.int64),
            "r": self.r_limbs.astype(np.int64),
            "r2": self.r2_limbs.astype(np.int64),
            "one": one,
            "np_low": _toeplitz(int_to_limbs(nprime_full, nlimbs), nlimbs).astype(np.float64),
            "p_cols": _toeplitz(self.p_limbs, 2 * nlimbs - 1).astype(np.float64),
            "w": np.array([1 << i for i in range(2 * nlimbs)], dtype=np.int64),
            "bits": np.arange(2 * nlimbs + 1, dtype=np.int64),
        }
        self._const_cache: dict = {}

    # -- host helpers (numpy, as in the reference) ---------------------------
    def to_mont_int(self, v: int) -> np.ndarray:
        return int_to_limbs((v * self.R) % self.modulus, self.nlimbs)

    def from_mont_limbs(self, a) -> int:
        return limbs_to_int(a) * pow(self.R, -1, self.modulus) % self.modulus

    def const(self, name: str, device) -> torch.Tensor:
        """The named field constant on `device`, built once per device: "p",
        "r" (R mod p, the Montgomery one), "r2", "one", and the tables of
        the carry and product steps."""
        key = (name, str(device))
        t = self._const_cache.get(key)
        if t is None:
            t = torch.as_tensor(self._host_consts[name], device=device)
            self._const_cache[key] = t
        return t

    # -- normalized-limb primitives ------------------------------------------
    def _carries(self, g, p):
        """Carry into each of the k limbs and out of the top, for per-limb
        generate g and propagate p (0/1, never both 1): c_0 = 0,
        c_{i+1} = g_i | (p_i & c_i).  One binary addition propagates them:
        with X = G + P and Y = G packed over the limbs, (X + Y) ^ X ^ Y
        holds c_i at bit i."""
        k = g.shape[-1]
        w = self.const("w", g.device)[:k]
        big_g = (g * w).sum(dim=-1)
        x = big_g + (p * w).sum(dim=-1)
        c = (x + big_g) ^ x ^ big_g
        bits = (c.unsqueeze(-1) >> self.const("bits", g.device)[: k + 1]) & 1
        return bits[..., :k], bits[..., k]

    def _carry_normalize(self, s, passes: int = 1):
        """Normalize nonnegative limbs to < 2^16; returns (limbs, top_carry).

        Each pass moves every limb's bits above 16 one limb up, cutting the
        excess by 16 bits: inputs < 2^31 need one pass before the carries
        are 0/1, inputs < 2^47 two, inputs < 2^63 three."""
        top = 0
        for _ in range(passes):
            hi = s >> 16
            top = top + hi[..., -1]
            s = (s & MASK16) + _shift_up(hi)
        cin, cout = self._carries(s >> 16, (s == MASK16).long())
        return (s + cin) & MASK16, cout + top

    def _sub_limbs(self, a, b):
        """(a - b) limbwise with borrow lookahead; both normalized.
        Returns (difference mod 2^(16n), final_borrow)."""
        bin_, bout = self._carries((a < b).long(), (a == b).long())
        return (a - b - bin_) & MASK16, bout

    def _sub_if_ge(self, a, top_extra=None):
        """Conditionally subtract the modulus when a >= p (a < 2p)."""
        diff, borrow = self._sub_limbs(a, self.const("p", a.device))
        ge = borrow == 0
        if top_extra is not None:
            # a has a virtual limb `top_extra` above the top; a >= p iff it
            # is nonzero or the subtraction did not borrow
            ge = ge | (top_extra > 0)
        return torch.where(ge.unsqueeze(-1), diff, a)

    def add(self, a, b):
        s, carry = self._carry_normalize(a + b)
        return self._sub_if_ge(s, top_extra=carry)

    def neg(self, a):
        """p - a for a in [0, p); maps 0 -> 0."""
        res, _ = self._sub_limbs(self.const("p", a.device).expand_as(a), a)
        return torch.where((a == 0).all(dim=-1, keepdim=True), a, res)

    def sub(self, a, b):
        """a - b mod p; adds p back on borrow."""
        diff, borrow = self._sub_limbs(a, b)
        corrected, _ = self._carry_normalize(diff + self.const("p", a.device))
        return torch.where((borrow != 0).unsqueeze(-1), corrected, diff)

    def mont_mul(self, a, b):
        """Montgomery product a*b*R^{-1} mod p over (..., nlimbs) tensors.

        T = a·b has 2n-1 columns < n·2^32.  m = (T mod R)·(-p^-1) mod R from
        T's normalized low limbs.  T + m·p is a multiple of R below 2pR:
        after normalizing, its high n limbs and top carry are the product,
        < 2p."""
        n = self.nlimbs
        a, b = torch.broadcast_tensors(a, b)
        t = _product_columns(a, b)  # (..., 2n-1) < n·2^32
        t_low, _ = self._carry_normalize(t[..., :n], passes=2)  # T mod R
        m = _columns(t_low, self.const("np_low", a.device))
        m, _ = self._carry_normalize(m, passes=2)  # mod R
        u = F.pad(t + _columns(m, self.const("p_cols", a.device)), (0, 1))  # (..., 2n) < 2^38
        u, top = self._carry_normalize(u, passes=2)
        return self._sub_if_ge(u[..., n:], top_extra=top)

    def to_mont(self, a):
        return self.mont_mul(a, self.const("r2", a.device))

    def from_mont(self, a):
        return self.mont_mul(a, self.const("one", a.device))

    def mont_pow(self, a, e: int):
        result = self.const("r", a.device).expand_as(a)
        base = a
        while e > 0:
            if e & 1:
                result = self.mont_mul(result, base)
            base = self.mont_mul(base, base)
            e >>= 1
        return result

    def mont_inv(self, a):
        return self.mont_pow(a, self.modulus - 2)


# BLS12-381 base and scalar fields
P_FP = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
P_FR = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

FP = LimbField(P_FP, 24)
FR = LimbField(P_FR, 16)
