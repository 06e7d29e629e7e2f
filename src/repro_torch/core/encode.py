"""Greedy token selection + per-chunk (local) compressed layout.

This is the encode half of the paper's Kernel I (§3.3.2): one thread per
chunk walks the chunk, emits a token at the current coding position (a
2-byte pointer if a long-enough match exists, else an S-byte literal), and
skips the symbols a match covers.

Two plain PyTorch selectors, equal by test:
  * ``select_tokens_scan``     — the paper's sequential walk (a loop over
    positions, all chunks at once).
  * ``select_tokens_doubling`` — the walk is the orbit of 0 under
    next(i) = i + step(i); the visited set comes from ceil(log2 (C+1))
    rounds of scatter + gather pointer doubling.
"""

from __future__ import annotations

import math

import torch


def min_match_length(symbol_size: int) -> int:
    """Minimum match length worth encoding as a 2-byte pointer.

    A pointer costs 2 bytes (+1 flag bit); a literal costs S bytes (+1 flag
    bit).  A match of length L replaces L literals (L*S bytes, L flag bits),
    so it pays off when L*S > 2, i.e. L >= floor(2/S) + 1.
    """
    return max(1, 2 // symbol_size + 1)


def _steps(lengths: torch.Tensor, min_match: int) -> torch.Tensor:
    return torch.where(lengths >= min_match, lengths, 1).to(torch.int32)


def select_tokens_scan(lengths: torch.Tensor, *, min_match: int) -> torch.Tensor:
    """(nc, C) match lengths -> (nc, C) bool 'a token is emitted here'."""
    nc, c = lengths.shape
    step = _steps(lengths, min_match)
    emitted = torch.zeros(nc, c, dtype=torch.bool, device=lengths.device)
    next_pos = torch.zeros(nc, dtype=torch.int32, device=lengths.device)
    for i in range(c):
        emit = next_pos == i
        emitted[:, i] = emit
        next_pos = torch.where(emit, i + step[:, i], next_pos)
    return emitted


def select_tokens_doubling(lengths: torch.Tensor, *, min_match: int) -> torch.Tensor:
    """Parallel selector: pointer-doubling orbit marking."""
    nc, c = lengths.shape
    dev = lengths.device
    step = _steps(lengths, min_match).to(torch.int64)
    idx = torch.arange(c, device=dev, dtype=torch.int64)[None, :]
    # Successor map over [0, C]; C is an absorbing end state.
    jump = torch.clamp(idx + step, max=c)
    jump = torch.cat([jump, torch.full((nc, 1), c, dtype=torch.int64, device=dev)], 1)
    visited = torch.zeros(nc, c + 1, dtype=torch.bool, device=dev)
    visited[:, 0] = True
    for _ in range(max(1, math.ceil(math.log2(c + 1)))):
        landed = torch.zeros(nc, c + 1, dtype=torch.int32, device=dev)
        landed.scatter_add_(1, jump, visited.to(torch.int32))
        visited = visited | (landed > 0)
        jump = torch.gather(jump, 1, jump)
    return visited[:, :c]


def token_fields(lengths, emitted, *, min_match: int, symbol_size: int) -> dict:
    """Derive per-position token metadata from the selection.

    Returns a dict with (nc, C) tensors:
      use_match: bool — emitted token is a pointer
      sizes:     int32 — encoded bytes contributed at this position (0 if none)
      local_off: int32 — exclusive prefix sum of sizes within the chunk
                 (the paper's *local prefix sum*, § 3.2.2)
    and (nc,) tensors:
      payload_sizes: int32 — compressed payload bytes per chunk
      n_tokens:      int32 — tokens per chunk (= flag bits)
    """
    use_match = emitted & (lengths >= min_match)
    sizes = torch.where(
        emitted, torch.where(use_match, 2, symbol_size), 0
    ).to(torch.int32)
    csum = torch.cumsum(sizes, dim=1, dtype=torch.int32)
    return dict(
        use_match=use_match,
        sizes=sizes,
        local_off=csum - sizes,  # exclusive
        payload_sizes=csum[:, -1].contiguous(),
        n_tokens=emitted.to(torch.int32).sum(dim=1, dtype=torch.int32),
    )
