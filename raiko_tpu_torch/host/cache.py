"""GuestInput disk cache per (network, block) with freshness validation
(reference host/src/cache.rs).

Validation (:43-76): a cached input is only usable if its block header
still hashes to the chain's block hash — a reorg or stale cache fails the
check and the input is regenerated."""

from __future__ import annotations

import os

from ..proto.input import GuestInput


def _path(cache_dir: str, network: str, block_number: int) -> str:
    return os.path.join(cache_dir, f"input-{network}-{block_number}.bin")


def get_input(cache_dir: str | None, block_number: int, network: str):
    if not cache_dir:
        return None
    try:
        with open(_path(cache_dir, network, block_number), "rb") as f:
            return GuestInput.from_bytes(f.read())
    except Exception:
        return None


def set_input(cache_dir: str | None, block_number: int, network: str, gi) -> None:
    if not cache_dir:
        return
    os.makedirs(cache_dir, exist_ok=True)
    with open(_path(cache_dir, network, block_number), "wb") as f:
        f.write(gi.to_bytes())


def validate_input(gi, provider) -> bool:
    """Cached header must match the chain (ref :43-76)."""
    try:
        header, _, _ = provider.get_blocks([gi.block_header.number])[0]
        return header.hash() == gi.block_header.hash()
    except Exception:
        return False
