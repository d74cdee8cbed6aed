"""Host-side utilities: hashing, codecs, timers."""

from .native import keccak256, keccak256_batch, native_available  # noqa: F401
from .keccak_py import KECCAK_EMPTY  # noqa: F401
