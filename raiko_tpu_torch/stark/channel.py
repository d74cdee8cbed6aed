"""Fiat-Shamir channel over a Poseidon2 sponge.

Both prover and verifier drive an identical transcript; every commitment /
sent value is absorbed before the next challenge is squeezed, making the
protocol non-interactive.  The sponge state is a width-16 Poseidon2 state;
absorption XOR-free (field addition into the rate), squeezing reads rate
elements, permuting between blocks — the standard duplex construction.

Query-index sampling masks squeezed elements to the domain's low bits
(negligible bias, static circuit form — see challenge_indices).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import babybear as bb
from ..ops import poseidon2_host as p2h


class Channel:
    """State lives HOST-SIDE in standard form and permutes with the pinned
    host Poseidon2 (bit-equal to the device kernel), in C
    (ops/poseidon2_host.py): a transcript makes dozens-to-thousands of
    tiny sequential sponge calls (grinding alone ~2^10), each of which
    would otherwise be a device round-trip."""

    def __init__(self):
        self._state = [0] * 16  # standard form
        self._pending: list[int] = []  # standard-form field elems to absorb

    # -- absorbing ------------------------------------------------------
    def absorb_elems(self, elems) -> None:
        """Absorb standard-form BabyBear ints."""
        for e in elems:
            self._pending.append(int(e) % bb.P)

    def absorb_digest(self, digest) -> None:
        """Absorb a Montgomery-form (8,) digest (Merkle root): a numpy
        array or a tensor on any device (copied to the host, which waits
        for the device)."""
        if isinstance(digest, torch.Tensor):
            digest = digest.cpu().numpy()
        vals = bb.np_from_mont(np.asarray(digest)).tolist()
        self.absorb_elems(vals)

    def absorb_ef(self, x: tuple) -> None:
        self.absorb_elems(list(x))

    def absorb_bytes(self, data: bytes) -> None:
        """Absorb arbitrary bytes as 31-bit chunks (injective per length)."""
        self.absorb_elems([len(data)])
        for i in range(0, len(data), 3):
            self.absorb_elems([int.from_bytes(data[i : i + 3], "big")])

    def _flush(self) -> None:
        """Permute pending absorptions into the state (rate 8)."""
        pend = self._pending
        self._pending = []
        self._state = p2h.absorb(self._state, pend)

    # -- squeezing ------------------------------------------------------
    def _squeeze_elems(self, n: int) -> list[int]:
        if self._pending:
            self._flush()
        # the state advances after every block read, so consecutive
        # squeezes are independent
        out, self._state = p2h.squeeze(self._state, n)
        return out

    def challenge(self) -> int:
        """One base-field challenge."""
        return self._squeeze_elems(1)[0]

    def challenge_ef(self) -> tuple:
        return tuple(self._squeeze_elems(4))

    def challenge_indices(self, count: int, domain_size: int) -> list[int]:
        """Query indices in [0, domain_size): the low bits of one squeezed
        element each.  The residual bias of masking a 31-bit BabyBear
        element to k bits is <= 2^k/p per index (~2^-19 at k=12) — the
        plonky3-style "sample bits" rule.  Chosen over rejection sampling
        so the sampling is a STATIC circuit (fixed squeeze count, one bit
        decomposition per index) for the recursive verifier
        (stark/recursion.py); a data-dependent rejection loop has no
        static-circuit form."""
        assert domain_size & (domain_size - 1) == 0
        return [self.challenge() & (domain_size - 1) for _ in range(count)]

    # -- grinding (FRI proof-of-work) -----------------------------------
    def grind(self, bits: int) -> int:
        """Prover: find a nonce whose absorption yields a challenge with
        ``bits`` leading zero bits, then leave it absorbed (queries sampled
        after the grind inherit its entropy).  Standard FRI grinding: adds
        ``bits`` of soundness against query-grinding attacks.

        The search runs VECTORIZED: ~2^bits candidate nonces, each costing
        a full sponge replay, made a multi-table block proof spend more
        wall-clock grinding (scalar-python permutations) than committing.
        The nonce lands at a fixed position of the final rate block, so
        every prior block is nonce-independent: process them once, then
        batch the final block + squeeze over candidate nonces with the
        batch permutation (bit-equal to host_permute) and take the
        SMALLEST qualifying nonce — identical output to the scalar loop.
        """
        pend = list(self._pending)
        # state after the nonce-independent full blocks
        full = (len(pend) // 8) * 8
        st = p2h.absorb(self._state, pend[:full])
        tail = pend[full:]  # the nonce joins this block at index len(tail)
        base_state = np.array(st, dtype=np.uint64)
        for i, v in enumerate(tail):
            base_state[i] = (base_state[i] + v) % bb.P
        pos = len(tail)
        batch = 4 << bits
        start = 0
        while True:
            nonces = np.arange(start, start + batch, dtype=np.uint64)
            states = np.tile(base_state, (batch, 1))
            states[:, pos] = (states[:, pos] + nonces % np.uint64(bb.P)) % np.uint64(bb.P)
            out = p2h.permute_batch(states)[:, 0]
            hits = np.nonzero((out >> np.uint64(31 - bits)) == 0)[0]
            if hits.size:
                nonce = int(nonces[hits[0]])
                break
            start += batch
        # leave the transcript exactly as the scalar loop would
        self.absorb_elems([nonce])
        assert self.challenge() >> (31 - bits) == 0
        return nonce

    def check_grind(self, nonce: int, bits: int) -> bool:
        """Verifier: replay the nonce absorption and check the difficulty."""
        self.absorb_elems([nonce])
        return self.challenge() >> (31 - bits) == 0
