"""Deterministic EVM re-execution (reference lib/src/builder.rs + revm).

The one genuinely sequential, branchy component of block proving
(SURVEY.md §7 "hard parts") — it runs on the host CPU; the TPU is the
proof-arithmetic engine.  The module provides a from-scratch Cancun-level
interpreter, journaled state over a pluggable database (MemDb for in-guest
execution, ProviderDb for preflight), and the block builder that
re-executes transactions and recomputes the state root."""
