"""Proof/receipt disk cache (reference provers/risc0/driver/src/bonsai.rs
:104-151 ``load_receipt``/``save_receipt`` analog).

The reference labels receipts ``{image_id}-{keccak(expected_output)}`` and
short-circuits proving on a hit.  Here the label is
``{statement_version}-{proof_type}-{keccak(instance_hash || canonical
config)}``: the statement version plays the image-id role (it changes
whenever the proven statement changes, as a new guest ELF would), and the
config hash invalidates entries when prover parameters change (budget,
mpt_version, shard size, ...).

Enabled when the request config carries ``proof_cache`` (true → default
dir, or a directory path), mirroring the reference's opt-in via the
risc0 param block.  The default directory is under the process's temporary
directory (``tempfile.gettempdir()``, which honours ``TMPDIR``)."""

from __future__ import annotations

import json
import logging
import os
import tempfile

from ..utils import keccak256

log = logging.getLogger("raiko.proof_cache")

# Bump whenever any prover statement semantics change — the image-id
# analog: stale cached proofs of an older statement must never hit.
STATEMENT_VERSION = 3

DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "raiko-tpu-proof-cache")

# Config keys that shape the proven statement / proof artifact.  Other
# request-config keys (network endpoints, cache paths) don't invalidate.
_STATEMENT_KEYS = (
    "mpt_version",
    "mpt_statement",
    "body_statement",
    "chain_statement",
    "evm_statement",
    "max_evm_frames",
    "max_evm_steps",
    "shard_size",
    "recursion",
)


def cache_dir(config: dict) -> str | None:
    pc = config.get("proof_cache")
    if not pc:
        return None
    return pc if isinstance(pc, str) else DEFAULT_DIR


def proof_label(proof_type: str, instance_hash: bytes, config: dict) -> str:
    relevant = {k: config[k] for k in _STATEMENT_KEYS if k in config}
    blob = json.dumps(relevant, sort_keys=True).encode()
    return (
        f"{STATEMENT_VERSION}-{proof_type}-"
        + keccak256(instance_hash + blob).hex()
    )


def load_proof(config: dict, proof_type: str, instance_hash: bytes) -> dict | None:
    """Cache hit → the stored payload dict; miss/corrupt/disabled → None."""
    d = cache_dir(config)
    if not d:
        return None
    path = os.path.join(d, proof_label(proof_type, instance_hash, config) + ".json")
    try:
        with open(path) as f:
            entry = json.load(f)
        # the reference re-checks the receipt's journal against the
        # expected output on load (bonsai.rs:155-176); our binding check:
        # the stored payload must claim the same instance hash
        if entry.get("instance_hash") != instance_hash.hex():
            log.warning("proof cache entry %s bound to wrong instance", path)
            return None
        log.info("loaded cached proof %s", path)
        return entry["payload"]
    except FileNotFoundError:
        return None
    except Exception:
        log.warning("corrupt proof cache entry %s", path, exc_info=True)
        return None


def save_proof(
    config: dict, proof_type: str, instance_hash: bytes, payload: dict
) -> None:
    d = cache_dir(config)
    if not d:
        return
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, proof_label(proof_type, instance_hash, config) + ".json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"instance_hash": instance_hash.hex(), "payload": payload}, f)
    os.replace(tmp, path)
