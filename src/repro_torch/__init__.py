"""GPULZ in PyTorch with CUDA kernels written for Hopper (sm_90a).

The port of the reference JAX package ``repro``: it imports ``torch`` and
``numpy`` only.  See ``repro_torch.core`` for the codec's public API.
"""
