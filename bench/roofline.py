"""The yardstick of the kernels' roofline, frozen here.

Peaks from NVIDIA's H100 SXM5 80GB HBM3 data sheet (dense, at the full
700 W limit; a card set below it runs slower, so a run prints its
``power.limit`` beside these):

    HBM_BW    = 3.35e12       bytes/s
    INT32_OPS = 67e12 / 4     int32 op/s of the CUDA cores (132 SMs x 64
                              int32 lanes x 1.98 GHz)

The count is the work the input needs, not any representation of it:

  * bytes: the field read once and the container written once (a read:
    the container read once and the field written once);
  * operations (only where a configuration names ``window_walk_compares``,
    and only for a write): the symbol compares a greedy far-to-near window
    walk makes on the field (``window_walk_compares``).

The least time is the larger of bytes / HBM_BW and operations / INT32_OPS.
"""

from __future__ import annotations

import torch

HBM_BW = 3.35e12
INT32_OPS = 67e12 / 4


def least_seconds(nbytes: float, ops: float) -> tuple:
    """(seconds, "bytes" or "operations"): the bound and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / INT32_OPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _capped_run_lengths(eq: torch.Tensor, levels: int) -> torch.Tensor:
    """min(run of ones starting at i, 2**levels) along the last axis."""
    r = eq.to(torch.int32)
    c = r.shape[-1]
    for k in range(levels):
        stride = 1 << k
        shifted = torch.zeros_like(r)
        if stride < c:
            shifted[..., : c - stride] = r[..., stride:]
        r = r + torch.where(r == stride, shifted, 0)
    return r


def window_walk_compares(sym: torch.Tensor, window: int) -> int:
    """Symbol compares of a greedy far-to-near window walk over the (nc, C)
    int32 symbols ``sym``, chunk by chunk.

    For each position i the walk visits offsets d = min(i, W) .. 1 while
    the cap min(d, 255, C - i) exceeds the best length so far; a visited
    offset costs one compare, plus min(run, cap - 1) more when its first
    symbol matches.
    """
    x = sym.to(torch.int32)
    nc, c = x.shape
    idx = torch.arange(c, device=x.device, dtype=torch.int32).expand(nc, c)
    padded = torch.cat([torch.zeros(nc, window, dtype=torch.int32, device=x.device), x], 1)
    best = torch.zeros_like(x)
    total = 0
    for d in range(window, 0, -1):
        cap = torch.clamp(c - idx, max=min(d, 255))
        visited = (idx >= d) & (cap > best)
        eq = (x == padded[:, window - d : window - d + c]) & (idx >= d)
        levels = 0
        while (1 << levels) < min(d, 255):
            levels += 1
        run = torch.minimum(_capped_run_lengths(eq, levels), cap)
        hit = eq & visited
        total += int(visited.sum()) + int(torch.minimum(run, cap - 1)[hit].sum())
        best = torch.where(visited & (run > best), run, best)
    return total


def symbols(field: torch.Tensor, symbol_size: int, chunk: int) -> torch.Tensor:
    """(nc, C) int32 little-endian symbols of a flat uint8 field, the last
    chunk zero-padded."""
    per = symbol_size * chunk
    n = -(-field.numel() // per) * per
    padded = torch.zeros(n, dtype=torch.uint8, device=field.device)
    padded[: field.numel()] = field
    b = padded.to(torch.int32).reshape(-1, symbol_size)
    sym = torch.zeros(b.shape[0], dtype=torch.int32, device=field.device)
    for k in range(symbol_size):
        sym |= b[:, k] << (8 * k)
    return sym.reshape(-1, chunk)
