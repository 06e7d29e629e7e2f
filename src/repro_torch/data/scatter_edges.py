"""Seeded inputs at the edges of Kernel III and of the byte histogram.

Kernel III (``csrc/lz_scatter.cu``, ``scatter``) gives each warp groups of
128 positions, 4 a lane, ranks a group's tokens by ballots and packs its
pointer bits into four words; a chunk whose flag words and payload fit
``STAGE_BYTES`` of shared memory builds its payload there (the staged
layout), a larger one writes it straight to the container (direct).  The
byte histogram (``csrc/lz_entropy.cu``) reads 16 bytes a load from the
range's first 16-byte boundary on, and its unaligned ends a byte at a
time.  The tests and ``chip_smoke.py`` hold both kernels to their plain
versions on these inputs, and the plain versions to the reference package.

Kernel III, ``scatter_inputs(kind, rows, nc, c, s, seed)``: Kernel-I
outputs as Kernel I defines them (``emitted`` marks token starts, a
pointer is an emitted position with ``lengths >= min_match``, and
``local_off`` is the exclusive prefix sum of token sizes, 2 for a pointer
and S for a literal); positions that are not emitted hold seeded junk.

  literals  every position a literal: C tokens, a C * S payload, flags 0
  matches   one symbol repeated and every token a pointer (lengths drawn
            in [min_match, 255], the last ending at the chunk's end): flag
            words all ones
  ragged    literals and short pointers at random, redrawn until a chunk's
            token count is not a multiple of 8 (so of neither 8 nor 32)
  mixed     the same without the redraw: over a row's chunks the flag and
            payload starts fall on every residue mod 16

at ``GEOMETRIES``: C in 8, 40, 2,056 and 32,768 at S = 1, 2, 4, and at each
S the largest C of the staged layout and the next multiple of 8 (direct),
two rows each.

The histogram, ``histogram_bytes(pattern, n, seed)``: all 0x00, all 0xFF,
one value (0x7F), alternating 0x00000000 / 0xFFFFFFFF words, uniform random
bytes; ``RANGES``, every length in {0, 1, 15, 16, 17} at every start mod
16; and ``BIG_BYTES`` (64 MiB) of one value for the card.
"""

from __future__ import annotations

import numpy as np

KINDS = ("literals", "matches", "ragged", "mixed")
STAGE_BYTES = 47 * 1024  # kStageBytes of csrc/lz_scatter.cu
GROUP = 128  # kGroup of csrc/lz_scatter.cu: positions a warp takes at a time
HIST_PATTERNS = ("zeros", "ones", "one-value", "alternating", "random")
RANGES = tuple((start, length) for length in (0, 1, 15, 16, 17) for start in range(16))
BIG_BYTES = 64 << 20


def min_match(s: int) -> int:
    """The shortest pointer at symbol size ``s`` (core/encode.py's rule)."""
    return max(1, 2 // s + 1)


def staged_bytes(c: int, s: int) -> int:
    """Shared memory of Kernel III's staged layout (``staged_bytes`` of the
    source): the flag words with a word of pad, the payload, one word."""
    return 4 * ((c + 31) // 32 + 1) + c * s + 4


def layout_edge(s: int) -> tuple:
    """(largest C staged, the next multiple of 8: direct) at symbol size s."""
    c = (STAGE_BYTES // s) // 8 * 8
    while staged_bytes(c, s) > STAGE_BYTES:
        c -= 8
    return c, c + 8


GEOMETRIES = tuple(
    [(c, s) for c in (8, 40, 2056, 32768) for s in (1, 2, 4)]
    + [(c, s) for s in (1, 2, 4) for c in layout_edge(s)]
)


def chunks_for(c: int) -> int:
    """Chunks a row at chunk size ``c``: enough small chunks for the mod-16
    residues, few large ones."""
    return 64 if c <= 64 else (4 if c <= 4096 else 2)


def _tokens(kind: str, c: int, s: int, rng):
    """Token starts and lengths of one chunk of ``kind``: a pointer covers
    its length in positions (at least min_match, at most 255 and what is
    left of the chunk), a literal one position."""
    mm = min_match(s)
    while True:
        starts, lens = [], []
        p = 0
        while p < c:
            rem = c - p
            if kind == "matches":
                n = rem if rem <= 255 else int(rng.integers(mm, min(255, rem - mm) + 1))
            elif kind == "literals" or rem < mm or rng.random() >= 0.4:
                n = int(rng.integers(0, mm))  # a literal: a length below min_match
            else:
                n = min(rem, mm + int(rng.geometric(0.15)) - 1)
            starts.append(p)
            lens.append(n)
            p += n if n >= mm else 1
        if kind != "ragged" or len(starts) % 8:
            return np.array(starts), np.array(lens)


def scatter_inputs(kind: str, rows: int, nc: int, c: int, s: int, seed: int = 0) -> dict:
    """(rows, nc, C) Kernel-I outputs of ``kind`` (see the module docstring):
    symbols, lengths, offsets, local_off int32, emitted bool; with
    (rows, nc) int32 n_tokens and payload_sizes."""
    if kind not in KINDS:
        raise ValueError(f"unknown Kernel III edge {kind!r}: one of {KINDS}")
    rng = np.random.default_rng(seed)
    n = rows * nc
    shape = (n, c)
    mm = min_match(s)
    if s == 4:
        symbols = rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64).astype(np.int32)
    else:
        symbols = rng.integers(0, 1 << (8 * s), shape).astype(np.int32)
    if kind == "matches":
        symbols[:] = symbols[:, :1]
    lengths = rng.integers(0, 256, shape).astype(np.int32)  # junk where not emitted
    offsets = rng.integers(1, 256, shape).astype(np.int32)
    emitted = np.zeros(shape, bool)
    for k in range(n):
        starts, lens = _tokens(kind, c, s, rng)
        emitted[k, starts] = True
        lengths[k, starts] = lens
    sizes = np.where(emitted, np.where(lengths >= mm, 2, s), 0).astype(np.int32)
    local_off = (np.cumsum(sizes, 1) - sizes).astype(np.int32)
    out = dict(symbols=symbols, lengths=lengths, offsets=offsets, emitted=emitted,
               local_off=local_off)
    out = {k: v.reshape(rows, nc, c) for k, v in out.items()}
    out["n_tokens"] = emitted.sum(1).astype(np.int32).reshape(rows, nc)
    out["payload_sizes"] = sizes.sum(1).astype(np.int32).reshape(rows, nc)
    return out


def section_offsets(n_tokens: np.ndarray, payload_sizes: np.ndarray):
    """Kernel II's (flag_off, pay_off) of (rows, nc) tables: exclusive sums of
    ceil(n_tokens / 8) and of the payload sizes, the latter past the row's
    flag total."""
    fs = (n_tokens.astype(np.int64) + 7) // 8
    ps = payload_sizes.astype(np.int64)
    flag_off = np.cumsum(fs, 1) - fs
    pay_off = np.cumsum(ps, 1) - ps + fs.sum(1, keepdims=True)
    return flag_off.astype(np.int32), pay_off.astype(np.int32)


def histogram_bytes(pattern: str, n: int, seed: int = 0) -> np.ndarray:
    """(n,) uint8 bytes of ``pattern`` (see the module docstring)."""
    if pattern == "zeros":
        return np.zeros(n, np.uint8)
    if pattern == "ones":
        return np.full(n, 0xFF, np.uint8)
    if pattern == "one-value":
        return np.full(n, 0x7F, np.uint8)
    if pattern == "alternating":
        return np.where(np.arange(n) // 4 % 2 == 0, 0x00, 0xFF).astype(np.uint8)
    if pattern == "random":
        return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)
    raise ValueError(f"unknown histogram edge {pattern!r}: one of {HIST_PATTERNS}")
