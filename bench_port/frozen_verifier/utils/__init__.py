"""Host utilities of the frozen verifier: Keccak-256 in plain Python."""

from .keccak_py import KECCAK_EMPTY, keccak256  # noqa: F401
