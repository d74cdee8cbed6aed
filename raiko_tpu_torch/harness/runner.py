"""Guest subprocess runner + in-guest test suite."""

from __future__ import annotations

import json
import subprocess
import sys
import traceback
from dataclasses import dataclass


@dataclass
class GuestResult:
    header_hash: str
    instance_hash: str
    state_root: str


def run_guest(
    guest_input_bytes: bytes, verifier: str = "None", timeout: float = 600.0
) -> GuestResult:
    """Execute the guest program in a separate process: GuestInput over
    stdin, JSON result on stdout (the SGX one-shot protocol shape)."""
    proc = subprocess.run(
        [sys.executable, "-m", "raiko_tpu_torch.harness.guest", "one-shot", verifier],
        input=guest_input_bytes,
        capture_output=True,
        timeout=timeout,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"guest failed ({proc.returncode}): {proc.stderr.decode()[-2000:]}"
        )
    out = json.loads(proc.stdout.decode())
    return GuestResult(**out)


class TestSuite:
    """In-guest test registry with logging, non-aborting assertions
    (reference harness/core TestSuite + assert shadowing)."""

    def __init__(self):
        self._tests: list = []
        self.failures: list[str] = []

    def register(self, fn):
        self._tests.append(fn)
        return fn

    # logging assertions (reference shadows assert!/assert_eq!)
    def check(self, cond, msg=""):
        if not cond:
            self.failures.append(f"assertion failed: {msg}")

    def check_eq(self, a, b, msg=""):
        if a != b:
            self.failures.append(f"assert_eq failed: {a!r} != {b!r} {msg}")

    def run(self) -> bool:
        """Run all tests; failures log and accumulate instead of aborting
        (the guest environment cannot catch_unwind)."""
        for fn in self._tests:
            try:
                fn(self)
            except Exception:
                self.failures.append(
                    f"{fn.__name__} raised:\n{traceback.format_exc()}"
                )
        for f in self.failures:
            print(f"[harness] {f}", file=sys.stderr)
        print(
            f"[harness] {len(self._tests)} tests, {len(self.failures)} failures",
            file=sys.stderr,
        )
        return not self.failures
