"""The roofline's counts against hand counts."""

from __future__ import annotations

import pytest
import torch

from bench import roofline


def walk_compares(chunk, window):
    """The walk as its docstring states it, one position at a time."""
    c, total = len(chunk), 0
    for i in range(c):
        best = 0
        for d in range(min(i, window), 0, -1):
            cap = min(d, 255, c - i)
            if cap <= best:
                continue
            total += 1
            if chunk[i] != chunk[i - d]:
                continue
            run = 0
            while run < cap and chunk[i + run] == chunk[i - d + run]:
                run += 1
            total += min(run, cap - 1)
            best = max(best, run)
    return total


@pytest.mark.parametrize("chunk", [
    [7] * 16,                      # one long run
    list(range(16)),               # no match anywhere
    [1, 2] * 8,                    # period two
    [3, 3, 4, 3, 3, 4, 5, 5, 5, 5, 3, 3, 4, 9, 9, 3],
])
@pytest.mark.parametrize("window", [1, 4, 16])
def test_compares_match_the_walk_by_hand(chunk, window):
    got = roofline.window_walk_compares(torch.tensor([chunk], dtype=torch.int32), window)
    assert got == walk_compares(chunk, window)


def test_hand_count_of_a_run():
    # eight equal symbols, W=2: position i >= 2 visits d=2 (cap 2 > 0: 1
    # compare + min(2, 1) more, best 2), then d=1 has cap 1 <= 2: skipped;
    # the last position's caps are 1: d=2 costs 1 + 0, d=1 is skipped.
    # i=1 visits d=1 only: 1 + 0.
    got = roofline.window_walk_compares(torch.tensor([[5] * 8], dtype=torch.int32), 2)
    assert got == 1 + 5 * 2 + 1


def test_chunks_are_independent():
    a = torch.tensor([[1, 2, 1, 2, 1, 2, 1, 2]], dtype=torch.int32)
    b = torch.tensor([[9, 9, 9, 9, 8, 8, 8, 8]], dtype=torch.int32)
    both = roofline.window_walk_compares(torch.cat([a, b]), 4)
    assert both == roofline.window_walk_compares(a, 4) + roofline.window_walk_compares(b, 4)


def test_symbols_pack_little_endian_and_pad():
    field = torch.tensor([1, 2, 3, 4, 5, 6], dtype=torch.uint8)
    sym = roofline.symbols(field, 2, 4)
    assert sym.tolist() == [[0x0201, 0x0403, 0x0605, 0]]


def test_least_seconds_takes_the_larger_term():
    t, by = roofline.least_seconds(3.35e12, 0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.least_seconds(1.0, 67e12 / 4 * 2)
    assert t == pytest.approx(2.0) and by == "operations"
