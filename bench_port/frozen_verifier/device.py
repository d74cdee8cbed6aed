"""The port's one device choice.

A caller names its device: the server and ``chip_smoke.py`` ask for
``cuda``, the CPU tests for ``cpu``.  There is no automatic fallback and no
environment override: asking for CUDA where there is no card raises.  On a
CPU device every kernel wrapper runs its plain PyTorch version; on a CUDA
device it launches its kernel or raises.
"""

from __future__ import annotations

import torch


def get(name: str | torch.device) -> torch.device:
    """The torch device for `name` ("cuda", "cuda:N" or "cpu"); raises if it
    is CUDA and no card is visible."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but torch sees no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev
