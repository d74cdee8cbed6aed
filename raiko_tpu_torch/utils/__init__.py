"""Host-side utilities: hashing, codecs, timers."""

from .native import implementation, keccak256, keccak256_batch  # noqa: F401
from .keccak_py import KECCAK_EMPTY  # noqa: F401
