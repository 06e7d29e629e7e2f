"""The port's kernels: CUDA sources in ``csrc/``, wrappers in ``ops``."""
