"""A frozen copy of the port's STARK verifier, the benchmark's reference for
proofs.

Copied from ``raiko_tpu_torch`` at commit ``c984b5b`` with its package
layout, so that a change to the port's verifier or AIRs cannot change the
yardstick: the fields, the AIRs of the EVM call tree and their
containment and keccak neighbours, the channel, domain, FRI, serde and
verifier modules, the plain (CPU) Poseidon2, NTT and Merkle paths and the
C host Poseidon2 (``csrc/poseidon2_host.cpp``, built by g++ at first use
into ``_build/`` here).  What differs from the port: ``stark/prover.py``
keeps only the proof's parameters, its record and the fixed segment's
commitment; ``kernels.py`` keeps only the C sources' path and the
counter, and ``ops/`` only the plain versions of the kernels;
``convert.py`` drops the KZG setup; ``utils`` hashes with the plain
Python Keccak.  It imports nothing of the port and runs on the CPU only.
"""
