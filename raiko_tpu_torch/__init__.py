"""raiko_tpu_torch: the PyTorch/CUDA port of raiko_tpu for one NVIDIA H100.

It imports torch and never jax, and nothing of the ``raiko_tpu`` package:
module paths mirror raiko_tpu's, and the framework-free host code (service,
orchestrator, EVM, tries, codecs, KZG host arithmetic) is the port's own
copy, with every device call an explicit call into the port on the torch
device the caller names.
"""
