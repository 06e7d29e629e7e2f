"""Seeded unit streams at the edges of the bitshuffle pair.

The CUDA pair (``csrc/lz_bitshuffle.cu``) gives a thread one 16-byte slot
(units 8j..8j+7 of a block, byte j of its 16 planes) and a CTA a tile of
``TILE_BLOCKS`` bitshuffle blocks; the last tile may be partial.  The
tests and ``chip_smoke.py`` hold the kernels to their plain versions on
these inputs, and the plain versions to the reference package:

  block counts  1, 2, 3 (a tile's first blocks only), TILE - 1, TILE,
                TILE + 1 (a last tile one block short, exactly full, and
                holding one block) and 4,097 (512 full tiles and a last
                tile of one block)
  patterns      zeros; ones (every unit 0xFFFF); sign (0x8000 only, the
                int16 sign bit); alternating (0xAAAA, 0x5555, ... unit by
                unit); random (uniform 16-bit units from the seed)
  one-hot       8,192 blocks: block 16u + b holds only bit b of unit u, so
                each (unit, bit) of a block lands on one (plane, byte, bit)
                of the output, which ``one_hot_expected`` builds from the
                wire layout's rule alone

Units are uint16 numpy arrays; ``torch.from_numpy(x.view(np.int16))`` gives
the int16 tensor the port takes.
"""

from __future__ import annotations

import numpy as np

BLOCK_UNITS = 512
BLOCK_BYTES = 1024
PLANE_BYTES = 64
TILE_BLOCKS = 8  # kTile of csrc/lz_bitshuffle.cu: bitshuffle blocks a CTA's tile
PATTERNS = ("zeros", "ones", "sign", "alternating", "random")
BLOCK_COUNTS = (1, 2, 3, TILE_BLOCKS - 1, TILE_BLOCKS, TILE_BLOCKS + 1, 4097)
ONE_HOT_BLOCKS = BLOCK_UNITS * 16


def edge_units(pattern: str, nblocks: int, seed: int = 0) -> np.ndarray:
    """(512 * nblocks,) uint16 units of ``pattern`` (see the module docstring)."""
    n = BLOCK_UNITS * nblocks
    if pattern == "zeros":
        return np.zeros(n, np.uint16)
    if pattern == "ones":
        return np.full(n, 0xFFFF, np.uint16)
    if pattern == "sign":
        return np.full(n, 0x8000, np.uint16)
    if pattern == "alternating":
        return np.where(np.arange(n) % 2 == 0, 0xAAAA, 0x5555).astype(np.uint16)
    if pattern == "random":
        return np.random.default_rng(seed).integers(0, 1 << 16, n).astype(np.uint16)
    raise ValueError(f"unknown bitshuffle edge {pattern!r}: one of {PATTERNS}")


def one_hot_units() -> np.ndarray:
    """(512 * 8192,) uint16: block 16u + b holds 1 << b at unit u, zeros elsewhere."""
    units = np.zeros(ONE_HOT_BLOCKS * BLOCK_UNITS, np.uint16)
    u, b = np.divmod(np.arange(ONE_HOT_BLOCKS), 16)
    units[np.arange(ONE_HOT_BLOCKS) * BLOCK_UNITS + u] = (1 << b).astype(np.uint16)
    return units


def one_hot_expected() -> np.ndarray:
    """The shuffled bytes of ``one_hot_units`` by the wire layout's rule: bit
    b of unit u is bit u % 8 of byte u // 8 of plane b."""
    out = np.zeros(ONE_HOT_BLOCKS * BLOCK_BYTES, np.uint8)
    u, b = np.divmod(np.arange(ONE_HOT_BLOCKS), 16)
    out[np.arange(ONE_HOT_BLOCKS) * BLOCK_BYTES + b * PLANE_BYTES + u // 8] = (
        1 << (u % 8)).astype(np.uint8)
    return out
