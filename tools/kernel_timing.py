"""What the kernel timing tools (``tools/time_*.py``) share: the refusal of
JAX and the JAX package, the ``--root``/``--label`` options, the card's name
and power limit, the switch to the timed checkout's ``raiko_tpu_torch`` and
its build with the ptxas report, and one JSON line per result.

A tool imports this module first, calls :func:`start`, and imports
``raiko_tpu_torch`` only after it, so the package it times is the one under
``--root``.  The timers are ``chip_smoke.py``'s own (``cuda_ms``,
``graph_ms``).
"""

from __future__ import annotations

import sys

for _name in ("jax", "jaxlib", "raiko_tpu"):
    sys.modules[_name] = None

import argparse
import json
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import cuda_ms, graph_ms  # noqa: E402,F401


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def start(doc: str, extra=None) -> argparse.Namespace:
    """Parse ``--root`` and ``--label`` (and what `extra` adds to the
    parser), print nvidia-smi's name and power limit, put the checkout under
    ``--root`` first on ``sys.path``, build its kernels and emit the build's
    ptxas lines.  Exits without a CUDA card."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--root", default=REPO, help="checkout whose raiko_tpu_torch to time")
    parser.add_argument("--label", default="", help="a name for this checkout in the output")
    if extra is not None:
        extra(parser)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{os.path.basename(sys.argv[0])}: torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, os.path.abspath(args.root))
    from raiko_tpu_torch import kernels

    kernels.library()
    with open(kernels.BUILD_INFO["log"]) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "entry function" in ln or "spill" in ln]
    emit(label=args.label, root=os.path.abspath(args.root), ptxas=ptxas)
    return args
