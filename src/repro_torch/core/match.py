"""Multi-byte LZSS matching (paper §3.2.3, §3.3.2): the plain PyTorch version.

For every position ``i`` of every chunk, the longest match whose source
starts in the window ``[i - min(i, W), i - 1]``.  Semantics (the same as the
reference package's ``core/match.py``):

  * matches never cross chunk boundaries (the chunk is the parallel unit);
  * a match's length is capped at ``min(offset, max_len, C - i)``, so a
    copy never overlaps itself (the parallel decoder relies on it);
  * ties between equal-length candidates go to the *largest* offset: the
    best candidate is the maximum of the key ``len * (W + 1) + d``.

The run length for one offset ``d`` is computed with the reference's capped
log-doubling recurrence over the equality row ``eq_d[i] = x[i] == x[i-d]``:

    r_0[i]     = eq[i]
    r_{k+1}[i] = r_k[i] + (r_k[i] == 2^k) * r_k[i + 2^k]   (= min(run, 2^{k+1}))

and offsets in ``(2^{k-1}, 2^k]`` need only ``k`` levels, because their
candidates are capped at ``d``.  The CUDA Kernel I (kernels/lz_match.py)
computes the same values with a direct far-to-near walk.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_LEN_CAP = 255  # lengths are encoded in one byte


def _ceil_log2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def capped_run_lengths(eq: torch.Tensor, levels: int) -> torch.Tensor:
    """min(run-length starting at i, 2^levels) for a 0/1 (nc, C) tensor."""
    r = eq.to(torch.int32)
    c = r.shape[-1]
    for k in range(levels):
        stride = 1 << k
        shifted = torch.zeros_like(r)
        if stride < c:
            shifted[..., : c - stride] = r[..., stride:]
        r = r + torch.where(r == stride, shifted, 0)
    return r


def find_matches(symbols: torch.Tensor, *, window: int, max_len: int = MAX_LEN_CAP):
    """(nc, C) int32 symbols -> (lengths, offsets), each (nc, C) int32.

    ``offsets`` is 0 where no match exists (length 0).
    """
    if symbols.dim() != 2:
        raise ValueError(f"symbols must be (num_chunks, C), got {tuple(symbols.shape)}")
    if not 1 <= window <= 255:
        raise ValueError(f"window must be in [1, 255], got {window}")
    x = symbols.to(torch.int32)
    nc, c = x.shape
    idx = torch.arange(c, device=x.device, dtype=torch.int32).expand(nc, c)
    padded = torch.cat([torch.zeros(nc, window, dtype=torch.int32, device=x.device), x], 1)
    pack = window + 1  # key = len * pack + d  (ties -> larger offset wins)
    max_levels = _ceil_log2(min(window, max_len))
    best = torch.zeros(nc, c, dtype=torch.int32, device=x.device)
    for d in range(1, window + 1):
        shifted = padded[:, window - d : window - d + c]
        eq = (x == shifted) & (idx >= d)
        r = capped_run_lengths(eq, min(_ceil_log2(d), max_levels))
        cand = torch.clamp(r, max=min(d, max_len))
        best = torch.maximum(best, cand * pack + d)
    lengths = best // pack
    offsets = torch.where(lengths > 0, best % pack, 0)
    return lengths, offsets


def find_matches_reference(symbols, *, window: int, max_len: int = MAX_LEN_CAP):
    """Brute-force O(C^2 W) oracle (numpy, host) for tests."""
    symbols = np.asarray(symbols)
    nc, c = symbols.shape
    lengths = np.zeros((nc, c), np.int32)
    offsets = np.zeros((nc, c), np.int32)
    for n in range(nc):
        for i in range(c):
            best_len, best_off = 0, 0
            for d in range(1, min(i, window) + 1):
                cap = min(d, max_len, c - i)
                ln = 0
                while ln < cap and symbols[n, i + ln] == symbols[n, i - d + ln]:
                    ln += 1
                # strict improvement, scanning far-to-near => largest-offset tie-break
                if ln > best_len or (ln == best_len and ln > 0 and d > best_off):
                    best_len, best_off = ln, d
            lengths[n, i] = best_len
            offsets[n, i] = best_off
    return lengths, offsets
