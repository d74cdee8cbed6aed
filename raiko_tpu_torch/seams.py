"""Point the reference package's device seams at the port.

The framework-free code of ``raiko_tpu`` (host, core, evm, proto, provers)
reaches JAX device code in five places.  ``bound(device)`` rebinds those
module attributes to the port for as long as it is held, and restores the
originals on exit; it edits no file.

* ``raiko_tpu.kzg.eip4844.tpu_default``: the device policy of every
  ``use_tpu=None`` call (preflight, L1 data, protocol instance, the prover's
  KZG proof), here "use the port's device";
* ``raiko_tpu.kzg.eip4844._msm``: the opening proof's MSM, reached through
  ``calc_kzg_proof`` -> ``compute_kzg_proof``;
* ``raiko_tpu.kzg.eip4844.blob_to_kzg_commitment`` and
  ``.blobs_to_kzg_commitments``: the commitment MSMs;
* ``raiko_tpu.evm.execute._batch_recover_senders``: batched sender
  recovery for blocks of 16 or more txs.

The server holds the binding for the whole process.  Tests enter and leave
it, so JAX tests in the same process see the reference unchanged.
``host_path()`` binds the same seams to the reference's host path instead.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from raiko_tpu.evm import execute as ref_execute
from raiko_tpu.kzg import eip4844 as ref_eip4844

from . import device as device_mod
from .kzg import eip4844
from .ops import secp

_lock = threading.Lock()


def _batch_recover_senders(txs, *, device: torch.device) -> list | None:
    """The port's ``execute._batch_recover_senders``: None below the batch
    threshold or off the card, else per-slot addresses or ValueErrors."""
    if len(txs) < ref_execute._BATCH_RECOVER_MIN or not secp.use_device_recovery(device):
        return None
    return secp.recover_senders(txs, device)


def _bindings(device: torch.device) -> dict:
    """(module, attribute) -> the port's replacement on `device`."""
    return {
        (ref_eip4844, "tpu_default"): lambda: True,
        (ref_eip4844, "_msm"): functools.partial(eip4844._msm, device=device),
        (ref_eip4844, "blob_to_kzg_commitment"): functools.partial(
            eip4844.blob_to_kzg_commitment, device=device
        ),
        (ref_eip4844, "blobs_to_kzg_commitments"): functools.partial(
            eip4844.blobs_to_kzg_commitments, device=device
        ),
        (ref_execute, "_batch_recover_senders"): functools.partial(
            _batch_recover_senders, device=device
        ),
    }


@contextlib.contextmanager
def _rebound(new: dict):
    """Hold `new` ((module, attribute) -> value) while the caller runs, and
    restore the originals after.  Not reentrant: a second binding while one
    is held raises."""
    if not _lock.acquire(blocking=False):
        raise RuntimeError("the port's seams are already bound")
    try:
        originals = {key: getattr(*key) for key in new}
        for (mod, name), fn in new.items():
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)
    finally:
        _lock.release()


@contextlib.contextmanager
def bound(device):
    """Hold the reference's device seams on the port at `device` ("cuda" or
    "cpu"); yields the torch device."""
    dev = device_mod.get(device)
    with _rebound(_bindings(dev)):
        yield dev


@contextlib.contextmanager
def host_path():
    """Hold the reference's device seams on its own host path: the host MSM
    (``host_curve.g1_msm``) for every KZG commitment and proof, and per-tx
    host sender recovery.  The reference orchestrator then proves a block
    with no device and no JAX, independently of the port: the result the
    port's answers are held against."""
    with _rebound({
        (ref_eip4844, "tpu_default"): lambda: False,
        (ref_execute, "_batch_recover_senders"): lambda txs: None,
    }):
        yield
