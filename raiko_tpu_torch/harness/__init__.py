"""Guest harness: subprocess guest runner + in-guest test suites
(reference harness/ + the SGX one-shot stdin/stdout protocol and
pipeline/'s guest-isolation role, reinterpreted for a Python guest).

The "guest" is the deterministic re-execution program
(calculate_block_header + ProtocolInstance).  ``run_guest`` executes it in
a separate OS process with the serialized GuestInput streamed over stdin
and a JSON result on stdout — the same process boundary the reference
crosses into its zkVM/enclave guests (provers/sgx/prover/src/lib.rs
:271-329), giving isolation and a stable serialization contract.

``TestSuite`` mirrors harness/'s zk_suits!: registered test functions run
inside the guest process with logging, non-aborting assertions
(harness/core/src/lib.rs:46-70).

Port of raiko_tpu/harness/: the runner spawns
``python -m raiko_tpu_torch.harness.guest``."""

from .runner import GuestResult, run_guest, TestSuite  # noqa: F401
