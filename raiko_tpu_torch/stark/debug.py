"""Host-side constraint checker — debug aid for AIR development.

Evaluates an AIR's constraints directly on a trace with exact modular
numpy arithmetic (no proving, no LDE) and reports which constraints fail
on which rows.  Used by tests to pinpoint broken constraints/traces long
before paying for a full prove() (minutes for the wide keccak tables).

Port of raiko_tpu/stark/debug.py, copied whole: host numpy with no device
code, so it gives the reference's verdicts (windows, constraint numbers,
messages and their order) on the port's AIRs, whose ``eval`` methods are
also what the quotient kernel's tape (``quotient_tape.py``) records.
"""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from .air import Air, ConstraintBuilder

_P = np.uint64(bb.P)


class _DebugAlgebra:
    """Vectorized standard-form evaluation over a row window."""

    def __init__(self, local, nxt, fixed_l, aux_l, aux_n, publics, chal, bus):
        self._l = local  # (W, k) uint64
        self._n = nxt
        self._f = fixed_l
        self._al = aux_l
        self._an = aux_n
        self._pub = publics
        self._chal = chal
        self._bus = bus
        self._k = local.shape[1]

    def _bc(self, v):
        return np.full(self._k, v % bb.P, dtype=np.uint64)

    def local(self, c):
        return self._l[c]

    def next(self, c):
        return self._n[c]

    def fixed(self, c):
        return self._f[c]

    def aux(self, c):
        return self._al[c]

    def aux_next(self, c):
        return self._an[c]

    def challenge_coord(self, k):
        return self._bc(self._chal[k])

    def bus_coord(self, k):
        return self._bc(self._bus[k])

    def public(self, i):
        return self._bc(self._pub[i])

    def constant(self, v):
        return self._bc(v)

    def local_block(self, cols):
        return self._l[np.asarray(cols)]

    def next_block(self, cols):
        return self._n[np.asarray(cols)]

    def fixed_block(self, cols):
        return self._f[np.asarray(cols)]

    def aux_block(self, cols):
        return self._al[np.asarray(cols)]

    def aux_next_block(self, cols):
        return self._an[np.asarray(cols)]

    def public_block(self, idxs):
        return np.stack([self._bc(self._pub[i]) for i in idxs])

    # np.asarray coercion: generic ConstraintBuilder block helpers
    # (linmap/const_vec fallbacks) produce Python LISTS of rows, and
    # list + list must mean elementwise add, not concatenation.
    def scale(self, k, a):
        return (np.asarray(a) * np.uint64(k % bb.P)) % _P

    def add(self, a, b):
        return (np.asarray(a) + np.asarray(b)) % _P

    def sub(self, a, b):
        return (np.asarray(a) + _P - np.asarray(b)) % _P

    def mul(self, a, b):
        return (np.asarray(a) * np.asarray(b)) % _P


def check_constraints(
    air: Air,
    trace: np.ndarray,
    publics: list[int] | None = None,
    challenges: list[tuple] | None = None,
    bus: list[tuple] | None = None,
    max_report: int = 10,
) -> list[str]:
    """Returns a list of human-readable violations (empty = satisfied).

    challenges/bus are supplied explicitly (any values work for
    debugging); aux is built via air.aux_trace when the AIR has one.
    """
    publics = publics or []
    n = trace.shape[0]
    tr = trace.T.astype(np.uint64) % _P  # (W, n)
    challenges = challenges or []
    chal_flat = [c % bb.P for t in challenges for c in t]
    if air.aux_width:
        aux = air.aux_trace(trace, challenges).T.astype(np.uint64) % _P
    else:
        aux = np.zeros((0, n), dtype=np.uint64)
    if bus is None and air.num_bus_values:
        bus = air.bus_values(trace, challenges)
    bus_flat = [c % bb.P for t in (bus or []) for c in t]
    fixed = air.fixed_columns(n)
    fixed = (
        fixed.astype(np.uint64) % _P
        if fixed is not None
        else np.zeros((0, n), dtype=np.uint64)
    )

    windows = {
        "transition": (
            tr[:, :-1],
            tr[:, 1:],
            fixed[:, :-1],
            aux[:, :-1],
            aux[:, 1:],
            np.arange(n - 1),
        ),
        "first_row": (
            tr[:, :1],
            tr[:, 1:2],
            fixed[:, :1],
            aux[:, :1],
            aux[:, 1:2],
            np.arange(1),
        ),
        "last_row": (
            tr[:, -1:],
            tr[:, -1:],  # next undefined on the last row; self is harmless
            fixed[:, -1:],
            aux[:, -1:],
            aux[:, -1:],
            np.arange(n - 1, n),
        ),
        "all_rows": (
            tr,
            np.roll(tr, -1, axis=1),  # cyclic wrap, matching the LDE domain
            fixed,
            aux,
            np.roll(aux, -1, axis=1),
            np.arange(n),
        ),
    }

    violations: list[str] = []
    for kind, (lo, nx, fx, al, an, rows) in windows.items():
        alg = _DebugAlgebra(lo, nx, fx, al, an, publics, chal_flat, bus_flat)
        builder = ConstraintBuilder(alg)
        air.eval(builder)
        ci = 0
        for con in builder.constraints:
            if con.kind != kind:
                ci += con.count
                continue
            expr = con.expr
            arr = np.atleast_2d(np.asarray(expr))
            for sub in range(arr.shape[0]):
                bad = np.nonzero(arr[sub] % bb.P)[0]
                if bad.size:
                    violations.append(
                        f"{kind} constraint #{ci + sub}: fails at rows "
                        f"{[int(rows[i]) for i in bad[:5]]}"
                        + (f" (+{bad.size - 5} more)" if bad.size > 5 else "")
                    )
                    if len(violations) >= max_report:
                        return violations
            ci += con.count
    return violations
