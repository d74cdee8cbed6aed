"""Core orchestration: preflight, providers, proof dispatch
(reference core/ crate)."""
