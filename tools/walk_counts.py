"""Offsets and read-on words of a one-word-a-warp window walk, counted on the CPU.

    PYTHONPATH=src python3 tools/walk_counts.py [N_CHUNKS]

A lane-by-lane model of a warp that owns 32 consecutive positions, walks
the offsets d = min(p + 31, W) .. 1 in lockstep with one equality ballot an
offset, stops every 4 offsets once no lane's cap exceeds its best length,
and reads on word by word (at the same d) for the runs that reach the top of
its word.  It checks its lengths and offsets against the plain matcher and
prints, per word of 32 positions, the offsets visited, the read-on words,
and the offsets at which position p + 31 is equal (the read-on branch is
taken).  N_CHUNKS (default 24) chunks of hurr-quant 128 MiB at S=2, W=128,
C=2048, drawn with a fixed seed.  These are counts, not device times.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.core import pipeline as pl
from repro_torch.core.match import find_matches
from repro_torch.data import datasets

C, W, S = 2048, 128, 2


def walk_word(x, p, counts):
    lanes = np.arange(32)
    i = p + lanes
    cap_lane = np.minimum(255, C - i)
    best_len, best_off = np.zeros(32, int), np.zeros(32, int)
    d = min(p + 31, W)
    while d >= 1:
        if d % 4 == 0 and np.all(np.minimum(d, cap_lane) <= best_len):
            break
        counts["offsets"] += 1
        eq = np.array([ii < C and ii >= d and x[ii] == x[ii - d] for ii in i])
        run = np.zeros(32, int)
        for l in range(32):  # equal positions from the lane's own up to the word's top
            while l + run[l] < 32 and eq[l + run[l]]:
                run[l] += 1
        cap = np.minimum(d, cap_lane)
        more = (run == 32 - lanes) & (run < cap) & (cap > best_len)
        if eq[31]:
            counts["branch"] += 1
        k = p + 32
        while more.any():  # the next word at the same d, as long as any lane needs it
            counts["read_on"] += 1
            e = np.array([k + l < C and x[k + l] == x[k + l - d] for l in range(32)])
            t = int(np.argmin(e)) if not e.all() else 32
            run = np.where(more, run + t, run)
            more &= (t == 32) & (run < cap)
            k += 32
        length = np.minimum(run, cap)
        better = length > best_len
        best_len = np.where(better, length, best_len)
        best_off = np.where(better, d, best_off)
        d -= 1
    return best_len, best_off


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    raw = datasets.load("hurr-quant", 128 << 20)
    sym = pl.pack_symbols(torch.from_numpy(raw[: C * S * 4096]), S).reshape(-1, C)
    counts = dict(offsets=0, read_on=0, branch=0)
    for k in np.random.default_rng(1).choice(sym.shape[0], n, replace=False):
        x = sym[k].numpy().astype(np.int64)
        lengths, offsets = np.zeros(C, int), np.zeros(C, int)
        for p in range(0, C, 32):
            lengths[p : p + 32], offsets[p : p + 32] = walk_word(x, p, counts)
        want = find_matches(sym[k : k + 1], window=W)
        assert np.array_equal(lengths, want[0][0].numpy()), "lengths differ from the plain matcher"
        assert np.array_equal(offsets, want[1][0].numpy()), "offsets differ from the plain matcher"
    words = n * C // 32
    print(f"{n} chunks, {words} words: per word {counts['offsets'] / words:.1f} offsets, "
          f"{counts['read_on'] / words:.1f} read-on words, read-on branch at "
          f"{counts['branch'] / words:.1f} offsets")


if __name__ == "__main__":
    main()
