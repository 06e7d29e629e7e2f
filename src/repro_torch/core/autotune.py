"""Chunk geometry for the Hopper kernels.

Only the static defaults and the shared-memory fit are here; the timed sweep
and its cache are still to be ported.  Every CUDA kernel of the port runs
one thread block per chunk with the chunk in shared memory, so the limit
is what one chunk needs, whatever ``chunks_per_block`` says.
"""

from __future__ import annotations

DEFAULT_CHUNK_SYMBOLS = 2048
DEFAULT_CHUNKS_PER_BLOCK = 8

# Shared memory one thread block may use on Hopper (sm_90: 227 KB).
SMEM_LIMIT_BYTES = 232_448
# Static shared memory of the kernels' block scans, beside the dynamic part.
SMEM_STATIC_BYTES = 1024


def kernel_smem_bytes(chunk_symbols: int, symbol_size: int) -> int:
    """Largest dynamic shared memory one chunk needs across the kernels.

    Kernel I holds the chunk's symbols (S bytes each) plus one length byte
    and one offset byte per position; the decoder holds two u16 copy-source
    rows; Kernel III holds the chunk's flag bytes, rounded to words.
    """
    c, s = chunk_symbols, symbol_size
    return max(c * s + 2 * c, 4 * c, 4 * -(-c // 32))


def validate_block_geometry(
    chunk_symbols: int, chunks_per_block: int, symbol_size: int
) -> None:
    """Reject a (C, g) pair the Hopper kernels could not run, naming it.

    ``chunks_per_block`` must be a positive int (it travels with configs
    that cross from the reference package) but has no effect on the
    kernels' shared-memory need.
    """
    c, g = chunk_symbols, chunks_per_block
    if not isinstance(g, int) or isinstance(g, bool) or g < 1:
        raise ValueError(
            f"chunks_per_block must be a positive int: got "
            f"(chunk_symbols={c}, chunks_per_block={g!r})"
        )
    need = kernel_smem_bytes(c, symbol_size) + SMEM_STATIC_BYTES
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"block geometry (chunk_symbols={c}, chunks_per_block={g}) needs "
            f"{need} bytes of shared memory per thread block at "
            f"symbol_size={symbol_size}, over the {SMEM_LIMIT_BYTES}-byte "
            f"Hopper limit — shrink chunk_symbols"
        )
