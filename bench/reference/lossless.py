"""The lossless guarantee: every byte comes back as it went in.

``compare`` counts the bytes that differ (a length difference counts as
that many bytes); the limit is 0, an exact comparison.  The control breaks
the guarantee: it clears the lowest bit of every symbol before the program
sees the data, as a codec that kept one bit less of each code would.
"""

from __future__ import annotations

import torch

LIMITS = {"mismatched_bytes": 0}


def codec_overrides(field: torch.Tensor, spec: dict) -> dict:
    return {}


def control(fields: torch.Tensor, spec: dict, symbol_size: int) -> torch.Tensor:
    """(fields, n) uint8 with bit 0 of each symbol's low byte cleared."""
    out = fields.clone()
    out[:, 0::symbol_size] &= 0xFE
    return out


def compare(field: torch.Tensor, out: torch.Tensor, spec: dict) -> dict:
    """``field`` and ``out`` are flat uint8 tensors on one device."""
    n = min(field.numel(), out.numel())
    diff = int((field[:n] != out[:n]).sum()) + abs(field.numel() - out.numel())
    return {"mismatched_bytes": diff}
