"""FRI low-degree test: commit and fold on the values' device, query
verification on the host.

Port of raiko_tpu/stark/fri.py.  Every layer's values live in
**bit-reversed order** over its (coset) domain.  In that order the fold
partners f(x), f(-x) are the adjacent pair (2t, 2t+1), so

    f'(x^2) = (f(x) + f(-x))/2 + beta * (f(x) - f(-x))/(2x)

is a reshape and a vectorized butterfly, no gather.  Each layer is
Merkle-committed with the *pair* as the leaf, so one query authenticates
both fold inputs: the (m/2, 8) leaf rows go through the
``poseidon2_hash_rows`` kernel and the tree through ``poseidon2_merkle``
on the card (ops/merkle.py), their plain versions on the CPU.

Values are extension-field (m, 4) Montgomery tensors; the per-pair 1/(2x)
tables are base-field, computed on the host per domain and moved to the
values' device.  ``replay_commit``, ``check_queries`` and the helpers
after them are the reference's host code, copied.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import babybear_ext as ef
from ..ops import merkle, ntt, poseidon2 as p2
from ..ops import poseidon2_host as p2h
from .channel import Channel

FOLD_ARITY = 2
FINAL_SIZE = 32  # stop folding at this many values (degree < FINAL_SIZE/blowup)
_HALF = pow(2, bb.P - 2, bb.P) * bb.R % bb.P  # 1/2, Montgomery form


@functools.lru_cache(maxsize=32)
def _inv2x_table(log_m: int, shift: int) -> np.ndarray:
    """1/(2x) for the first element x of each bitrev pair, for the coset
    shift*H of size 2^log_m.  Returns (m/2,) u32 Montgomery."""
    m = 1 << log_m
    w = bb.two_adic_generator(log_m)
    rev = ntt.bit_reverse_indices(m)
    out = np.empty(m // 2, dtype=np.uint32)
    for t in range(m // 2):
        x = shift * pow(w, int(rev[2 * t]), bb.P) % bb.P
        out[t] = pow(2 * x, bb.P - 2, bb.P)
    return bb.np_to_mont(out)


@functools.lru_cache(maxsize=32)
def _x_first_of_pair(log_m: int, shift: int, index: int) -> int:
    m = 1 << log_m
    w = bb.two_adic_generator(log_m)
    rev = ntt.bit_reverse_indices(m)
    return shift * pow(w, int(rev[index]), bb.P) % bb.P


def fold_layer(values: torch.Tensor, inv2x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """One FRI fold. values: (m, 4) EF bitrev order; inv2x: (m/2,) base;
    beta: (4,) EF challenge, all on one device.  Returns (m/2, 4) in the
    values' dtype."""
    pairs = values.reshape(values.shape[0] // 2, 2, 4)
    a = pairs[:, 0, :]
    c = pairs[:, 1, :]
    s = bb.mont_mul(ef.ef_add(a, c), _HALF)  # (f(x)+f(-x)) / 2
    d = ef.ef_mul_base(ef.ef_sub(a, c), inv2x)  # (f(x)-f(-x)) / (2x)
    return ef.ef_add(s, ef.ef_mul(d, beta[None, :]))


def _hash_commit(values: torch.Tensor) -> list[torch.Tensor]:
    """Merkle levels over a layer's (m/2, 8) pair rows: one launch each of
    poseidon2_hash_rows and poseidon2_merkle on the card."""
    return merkle.commit(p2.hash_rows(values.reshape(values.shape[0] // 2, 8)))


@dataclass
class FriProof:
    layer_roots: list  # list of (8,) int digests (standard form)
    final_values: list  # FINAL_SIZE EF tuples (standard form, bitrev order)
    # per query: list over layers of (pair_values, merkle_path)
    query_proofs: list


def commit(values: torch.Tensor, log_m: int, shift: int, channel: Channel):
    """FRI commit phase.  values: (m, 4) int32 EF Montgomery, bitrev order
    over the coset shift*H, on any device.  Absorbs roots into the channel;
    returns (layers_data, layer_roots, final_values) where layers_data
    keeps the tensors and Merkle levels for the query phase."""
    layers = []
    roots = []
    cur = values
    cur_log = log_m
    cur_shift = shift
    while cur.shape[0] > FINAL_SIZE:
        levels = _hash_commit(cur)
        root = merkle.root(levels)
        channel.absorb_digest(root)
        beta = channel.challenge_ef()
        inv2x = torch.as_tensor(_inv2x_table(cur_log, cur_shift).astype(np.int32), device=cur.device)
        nxt = fold_layer(cur, inv2x, ef.to_device([beta], cur.device)[0])
        layers.append(
            {
                "values": cur,
                "levels": levels,
                "log_m": cur_log,
                "shift": cur_shift,
                "beta": beta,
            }
        )
        roots.append(root)
        cur = nxt
        cur_log -= 1
        cur_shift = cur_shift * cur_shift % bb.P
    final_vals = ef.from_device(cur)
    for v in final_vals:
        channel.absorb_ef(v)
    return layers, roots, final_vals


def open_queries(layers, indices: list[int]):
    """Produce query proofs for the given base-layer indices: per layer,
    one gather of the queried pairs and one per tree level for the
    sibling nodes (merkle.open_paths), each one transfer to the host."""
    n_q = len(indices)
    out = [[] for _ in range(n_q)]
    cur = np.asarray(indices, np.int64)
    for layer in layers:
        pair_idx = cur // 2
        m = layer["values"].shape[0]
        pairs = layer["values"].reshape(m // 2, 2, 4)
        sel = pairs.index_select(0, torch.as_tensor(pair_idx, device=pairs.device))
        vals_std = ef.from_device(sel.reshape(-1, 4))  # 2 per query
        paths = merkle.open_paths(layer["levels"], pair_idx.tolist())
        for q in range(n_q):
            out[q].append(
                {
                    "pair": vals_std[2 * q : 2 * q + 2],
                    "path": [p.tolist() for p in paths[q]],
                }
            )
        cur = pair_idx
    return out


def replay_commit(proof: FriProof, log_m: int, shift: int, channel: Channel):
    """Verifier: replay the commit-phase transcript, re-deriving betas and
    checking the final polynomial's degree.  Returns betas or None on
    failure.  The caller derives the query indices from the channel AFTER
    this (matching the prover's order)."""
    betas = []
    cur_log = log_m
    n_layers = len(proof.layer_roots)
    # the prover folds until <= FINAL_SIZE values remain; a domain already
    # at or below FINAL_SIZE (tiny tables) legitimately has zero layers
    expected_layers = max(0, log_m - (FINAL_SIZE.bit_length() - 1))
    if n_layers != expected_layers:
        return None
    for root in proof.layer_roots:
        channel.absorb_elems(root)
        betas.append(channel.challenge_ef())
        cur_log -= 1
    if (1 << cur_log) != len(proof.final_values):
        return None
    for v in proof.final_values:
        channel.absorb_ef(tuple(v))
    final_shift = shift
    for _ in range(n_layers):
        final_shift = final_shift * final_shift % bb.P
    if not _final_poly_ok(proof.final_values, cur_log, final_shift):
        return None
    return betas


def check_queries(
    proof: FriProof,
    betas: list[tuple],
    log_m: int,
    shift: int,
    indices_and_first_values: list[tuple[int, tuple]],
) -> bool:
    """Verifier: per-query fold-consistency and Merkle checks.  Each query
    index comes with the verifier-recomputed base-layer value there."""
    n_layers = len(proof.layer_roots)
    half = pow(2, bb.P - 2, bb.P)
    for (idx, base_value), per_layer in zip(
        indices_and_first_values, proof.query_proofs
    ):
        if len(per_layer) != n_layers:
            return False
        cur_idx = idx
        expected = tuple(int(x) % bb.P for x in base_value)
        cur_log2 = log_m
        cur_shift = shift
        for li, layer in enumerate(per_layer):
            pair = [tuple(int(v) % bb.P for v in p) for p in layer["pair"]]
            pair_idx = cur_idx // 2
            if pair[cur_idx & 1] != expected:
                return False
            leaf_row = ef_pair_to_row(pair)
            if not _verify_leaf(
                leaf_row, pair_idx, layer["path"], proof.layer_roots[li]
            ):
                return False
            x = _x_first_of_pair(cur_log2, cur_shift, 2 * pair_idx)
            inv2x = pow(2 * x, bb.P - 2, bb.P)
            a, c = pair
            s = tuple(v * half % bb.P for v in ef.h_add(a, c))
            d = tuple(v * inv2x % bb.P for v in ef.h_sub(a, c))
            expected = ef.h_add(s, ef.h_mul(d, betas[li]))
            cur_idx = pair_idx
            cur_log2 -= 1
            cur_shift = cur_shift * cur_shift % bb.P
        if tuple(proof.final_values[cur_idx]) != expected:
            return False
    return True


def ef_pair_to_row(pair) -> np.ndarray:
    """Two EF tuples -> (8,) Montgomery leaf row."""
    flat = np.array(list(pair[0]) + list(pair[1]), dtype=np.uint64)
    return ((flat * bb.R) % bb.P).astype(np.uint32)


def _verify_leaf(leaf_row, index, path, root) -> bool:
    """Host-side leaf + path check (8-wide FRI leaves: one host permutation
    each; a device call per leaf would cost ~150 ms through the relay)."""
    leaf_std = bb.np_from_mont(np.asarray(leaf_row))
    return p2h.row_path_ok(leaf_std, index, path, root)


def _final_poly_ok(final_values, log_m: int, shift: int) -> bool:
    """Interpolate the final layer (host) and check degree < m/4."""
    m = 1 << log_m
    vals = [tuple(int(x) % bb.P for x in v) for v in final_values]
    rev = ntt.bit_reverse_indices(m)
    w = bb.two_adic_generator(log_m)
    nat = [None] * m
    for i in range(m):
        nat[int(rev[i])] = vals[i]
    # coefficients via inverse DFT (host, m = FINAL_SIZE is tiny)
    m_inv = pow(m, bb.P - 2, bb.P)
    winv = pow(w, bb.P - 2, bb.P)
    shift_inv = pow(shift, bb.P - 2, bb.P)
    coeffs = []
    for k in range(m):
        acc = ef.H_ZERO
        for j in range(m):
            term = tuple(
                v * pow(winv, j * k, bb.P) % bb.P for v in nat[j]
            )
            acc = ef.h_add(acc, term)
        coeff = tuple(v * m_inv % bb.P * pow(shift_inv, k, bb.P) % bb.P for v in acc)
        coeffs.append(coeff)
    for c in coeffs[m // 4 :]:
        if c != ef.H_ZERO:
            return False
    return True
