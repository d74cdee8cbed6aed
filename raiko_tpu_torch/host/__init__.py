"""Host service: HTTP API, proof scheduler, metrics, cache
(reference host/ crate)."""
