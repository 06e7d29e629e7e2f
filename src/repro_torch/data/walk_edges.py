"""Seeded chunks of symbols at the window walk's edges.

The CUDA walk (``csrc/kernel1.cuh``) reads a position's run off a warp's
32-bit equality word and extends it word by word; these inputs put runs
where that can go wrong, for the tests and ``chip_smoke.py`` to hold the
kernels to their plain versions (and the plain versions to the reference):

  word-cross  copies of earlier stretches that start a few positions before
              a multiple of 32 (a word) and of 256 (a block's tile) and
              run across it;
  cap         long all-equal stretches and a period-3 stretch, whose runs
              reach the 255 cap at W=255;
  chunk-end   a copy (even chunks) or a run of one symbol (odd chunks) that
              ends exactly at the chunk's last position;
  ties        one motif repeated at several offsets, so equal lengths tie;
  all-equal   one symbol everywhere (the walk stops at its first offset);
  noise2      two symbols at random, which differ only in their top bit
              (every offset is visited, runs are short).

Each returns (nc, C) int32 symbols of ``symbol_size`` bytes (at S=4 the
bit pattern counts; a symbol may be negative).
"""

from __future__ import annotations

import numpy as np

KINDS = ("word-cross", "cap", "chunk-end", "ties", "all-equal", "noise2")


def _copy(x: np.ndarray, start: int, length: int, d: int) -> None:
    """x[start : start + length] = x[start - d : ...], symbol by symbol (a
    copy longer than d repeats its source, as LZSS decoding does)."""
    for k in range(start, min(start + length, x.size)):
        x[k] = x[k - d]


def _chunk(kind: str, c: int, window: int, vmax: int, rng, odd: bool) -> np.ndarray:
    x = rng.integers(0, vmax, c, dtype=np.int64)
    if kind == "word-cross":
        for q in range(32, c, 32):
            start = q - int(rng.integers(1, 6)) - (5 if q % 256 == 0 else 0)
            d = int(rng.integers(1, window + 1))
            if start - d >= 0 and rng.random() < 0.5:
                _copy(x, start, int(rng.integers(20, 120)), d)
    elif kind == "cap":
        for q in range(int(rng.integers(0, 40)), c, 1000):
            x[q : q + 700] = x[q]
        q = c // 2 + 13
        _copy(x, q + 3, 400, 3)
    elif kind == "chunk-end" and odd:
        x[c - min(300, c // 2) :] = x[-1]
    elif kind == "chunk-end":
        tail = min(37, c // 2)
        _copy(x, c - tail, tail, min(window, c - tail))
    elif kind == "ties":
        motif = rng.integers(0, vmax, 12, dtype=np.int64)
        for q in range(5, c - 12, int(rng.integers(13, 40))):
            x[q : q + 12] = motif
    elif kind == "all-equal":
        x[:] = 7 % vmax
    elif kind == "noise2":
        x = rng.integers(0, 2, c, dtype=np.int64) * (vmax >> 1) + 1
    else:
        raise ValueError(f"unknown walk edge {kind!r}: one of {KINDS}")
    return x


def walk_edge_symbols(kind: str, nc: int, c: int, symbol_size: int, window: int,
                      seed: int = 0) -> np.ndarray:
    """(nc, c) int32 symbols of ``kind`` (see the module docstring)."""
    rng = np.random.default_rng([seed, c, symbol_size, window, KINDS.index(kind)])
    vmax = 1 << (8 * symbol_size)
    x = np.stack([_chunk(kind, c, window, vmax, rng, k % 2 == 1) for k in range(nc)])
    return x.astype(np.uint32).view(np.int32)
