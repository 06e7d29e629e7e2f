"""The plain reference: a decoder of the GPULZ container format and one
module a guarantee.  Plain NumPy and PyTorch: nothing here imports the
program (``repro_torch``), the JAX package or JAX."""
