"""Bit-plane transpose (bitshuffle) over uint16 unit streams.

FZ-GPU's pre-stage for error-bounded scientific data: after dual-quant,
most uint16 code bits are zero or slowly varying but interleaved across
bit positions inside each unit; transposing each block of units into bit
planes groups the near-constant high bits into long byte runs, which LZSS
and the deflate-full stage compress well.

Layout (fixed, part of the method-2 wire format):

  * the stream is processed in blocks of ``BLOCK_UNITS = 512`` uint16 units
    (1024 bytes); callers pad to a multiple (padding value 0).
  * within a block, output plane ``b`` (b = 0..15, LSB first) is 64 bytes;
    its byte ``j`` packs bit ``b`` of units ``8j .. 8j+7``, unit ``8j`` in
    the byte's LSB.
  * blocks are emitted back to back, planes in order within each block, so
    the output byte count equals the input byte count.

Units are the 16-bit patterns of ``torch.int16`` tensors.  ``shuffle`` /
``unshuffle`` go through ``kernels/ops.py`` (the CUDA kernels on a CUDA
tensor, the plain versions on a CPU tensor); ``impl="plain"`` asks for the
plain versions on any device, which is how the plain path is run on the
card to be compared with the kernels.
"""

from __future__ import annotations

from repro_torch.kernels import lz_bitshuffle as _bshuf

BLOCK_UNITS = _bshuf.BLOCK_UNITS
BLOCK_BYTES = _bshuf.BLOCK_BYTES
PLANES = _bshuf.PLANES
PLANE_BYTES = _bshuf.PLANE_BYTES

shuffle_plain = _bshuf.bitshuffle_plain
unshuffle_plain = _bshuf.bitunshuffle_plain


def _check_impl(impl):
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain': {impl!r}")


def padded_units(n_units: int) -> int:
    """Smallest multiple of BLOCK_UNITS holding ``n_units``."""
    return -(-max(n_units, 1) // BLOCK_UNITS) * BLOCK_UNITS


def shuffle(units, impl=None, out=None):
    """Bit-plane transpose of a padded (N,) int16 unit stream -> (2N,) uint8;
    with ``out`` (a contiguous uint8 tensor of at least 2N bytes), written
    into its prefix and that prefix returned."""
    _check_impl(impl)
    if units.shape[0] % BLOCK_UNITS:
        raise ValueError(
            f"bitshuffle input must be a multiple of {BLOCK_UNITS} units: "
            f"{units.shape[0]}"
        )
    if impl == "plain":
        return _bshuf.write_into(out, shuffle_plain(units), "bitshuffle")
    from repro_torch.kernels import ops

    return ops.bitshuffle(units, out)


def unshuffle(shuffled, impl=None):
    """Inverse of ``shuffle``; input length a multiple of 1024 bytes."""
    _check_impl(impl)
    if shuffled.shape[0] % BLOCK_BYTES:
        raise ValueError(
            f"bitshuffle inverse input must be a multiple of {BLOCK_BYTES} "
            f"bytes: {shuffled.shape[0]}"
        )
    if impl == "plain":
        return unshuffle_plain(shuffled)
    from repro_torch.kernels import ops

    return ops.bitunshuffle(shuffled)
