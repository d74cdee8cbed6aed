"""The guest program entry point (python -m raiko_tpu_torch.harness.guest).

Port of raiko_tpu/harness/guest.py: the guest re-executes on the host
(``device=None``), with no device work.

Subcommands (mirroring the SGX guest's one_shot shape):
  one-shot [verifier]  — read GuestInput from stdin, re-execute, print
                         {header_hash, instance_hash, state_root} JSON
  test                 — run the in-guest test suite
"""

from __future__ import annotations

import json
import sys


def one_shot(verifier: str) -> int:
    from ..evm.builder import calculate_block_header
    from ..proto.input import GuestInput
    from ..proto.instance import ProtocolInstance
    from ..utils.measurement import CycleTracker

    data = sys.stdin.buffer.read()
    gi = GuestInput.from_bytes(data)
    ct = CycleTracker("execute")
    header = calculate_block_header(gi, device=None)
    ct.end()
    pi = ProtocolInstance.new(gi, header, verifier, None)
    print(
        json.dumps(
            {
                "header_hash": "0x" + header.hash().hex(),
                "instance_hash": "0x" + pi.instance_hash().hex(),
                "state_root": "0x" + header.state_root.hex(),
            }
        )
    )
    return 0


def run_tests() -> int:
    """In-guest self tests: primitives exercised inside the guest process
    (reference guests run sha/keccak suites in-zkVM)."""
    from .runner import TestSuite
    from ..utils.keccak_py import KECCAK_EMPTY, keccak256

    suite = TestSuite()

    @suite.register
    def keccak_vectors(s):
        s.check_eq(keccak256(b""), KECCAK_EMPTY, "empty keccak")
        s.check_eq(
            keccak256(b"abc").hex(),
            "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45",
        )

    @suite.register
    def rlp_roundtrip(s):
        from ..proto import rlp

        s.check_eq(rlp.decode(rlp.encode([b"a", [b"b"]])), [b"a", [b"b"]])

    @suite.register
    def secp_recover(s):
        from ..utils import secp256k1

        msg = keccak256(b"guest")
        r, sg, rec = secp256k1.sign(msg, 7)
        addr = secp256k1.pubkey_to_address(secp256k1.pubkey(7))
        s.check_eq(secp256k1.ecrecover(msg, 27 + rec, r, sg), addr)

    return 0 if suite.run() else 1


def main() -> int:
    cmd = sys.argv[1] if len(sys.argv) > 1 else "one-shot"
    if cmd == "one-shot":
        return one_shot(sys.argv[2] if len(sys.argv) > 2 else "None")
    if cmd == "test":
        return run_tests()
    print(f"unknown subcommand {cmd}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
