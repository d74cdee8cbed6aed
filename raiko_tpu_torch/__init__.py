"""raiko_tpu_torch: the PyTorch/CUDA port of raiko_tpu for one NVIDIA H100.

It imports torch and never jax.  Module paths mirror raiko_tpu's; the
reference package's framework-free host code is reused as it is, with its
device seams bound to the port by ``seams.bound(device)``.
"""
