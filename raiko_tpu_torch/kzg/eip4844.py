"""EIP-4844 KZG commitments and opening-proof MSMs on the port's device.

Port of the device half of raiko_tpu/kzg/eip4844.py: ``_device_setup``,
``_msm``, ``blob_to_kzg_commitment`` and ``blobs_to_kzg_commitments``.
Everything else (the trusted setup, blob parsing, the opening proof's
quotient, verification, compression) is host code and stays in the
reference module, which ``seams.bound`` points at these functions.

``use_tpu`` keeps the reference's meaning, "run the MSM on the device":
here the device is the one the caller names.  ``None`` selects the device,
as the reference's policy does on its accelerator; ``False`` is the
reference's own host path, run by the reference's functions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from raiko_tpu.kzg import eip4844 as ref
from raiko_tpu.kzg import host_curve as hc

from .. import convert
from ..ops import msm as msmmod
from . import curve

# The reference's functions, taken before ``seams.bound`` can rebind them
# (seams imports this module first): the host path (use_tpu=False) is theirs.
_ref_msm = ref._msm
_ref_blob_to_kzg_commitment = ref.blob_to_kzg_commitment
_ref_blobs_to_kzg_commitments = ref.blobs_to_kzg_commitments


@functools.lru_cache(maxsize=None)
def _device_setup(device: torch.device) -> torch.Tensor:
    """Trusted-setup G1 points on `device`, (4096, 3, 24), built once."""
    return convert.setup_points(device)


def _use_device(use_tpu: bool | None) -> bool:
    return True if use_tpu is None else use_tpu


def _limbs(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(arr.astype(np.int64), device=device)


def _msm(scalars: list[int], use_tpu: bool | None, *, device: torch.device) -> tuple[int, int] | None:
    """Σ scalars_i · setup_i as an affine point (None = infinity)."""
    if not _use_device(use_tpu):
        return _ref_msm(scalars, False)
    res = msmmod.msm(_device_setup(device), _limbs(msmmod.scalars_to_limbs(scalars), device))
    return curve.to_affine(res)


def blob_to_kzg_commitment(blob: bytes, use_tpu: bool | None = True, *, device: torch.device) -> bytes:
    """48-byte compressed commitment of one blob."""
    if not _use_device(use_tpu):
        return _ref_blob_to_kzg_commitment(blob, False)
    res = msmmod.msm(_device_setup(device), _limbs(ref.blob_to_limbs(blob), device))
    return hc.g1_compress(curve.to_affine(res))


def blobs_to_kzg_commitments(
    blobs: list[bytes], use_tpu: bool | None = True, *, device: torch.device
) -> list[bytes]:
    """Commitments of several blobs as one batched MSM (``msm_multi``)."""
    if not blobs:
        return []
    if not _use_device(use_tpu):
        return _ref_blobs_to_kzg_commitments(blobs, False)
    limbs = np.stack([ref.blob_to_limbs(b) for b in blobs])
    res = msmmod.msm_multi(_device_setup(device), _limbs(limbs, device)).cpu()
    return [hc.g1_compress(curve.to_affine(res[i])) for i in range(len(blobs))]
