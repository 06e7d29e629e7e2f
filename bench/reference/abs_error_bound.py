"""The error-bounded guarantee of ``lossy-fz``: max |x' - x| <= eb.

``eb = rel_to_range * (max - min)`` of each field (cuSZ's ``-m r2r``),
and the format honours its float32 rounding ``eb32``.  Two numbers are
compared, on the float32 elements of a field:

  * ``max_err_over_eb``: max |x' - x| / eb32, worked out in float64; the
    limit is 1, the bound the configuration states;
  * ``off_grid``: elements that are neither x itself (an exact outlier)
    nor the quantizer's reconstruction ``fl32(q) * fl32(2 eb32)`` with
    ``q = round(x * fl32(1 / fl32(2 eb32)))`` (float32, NaN as 0,
    clipped to +-2**30); an exact comparison, limit 0.

The control computes the field in the precision below float32 before the
program sees it: bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference.gplz import prequant

LIMITS = {"max_err_over_eb": 1.0, "off_grid": 0}


def bound(field: torch.Tensor, spec: dict) -> float:
    """The absolute bound of one field (a flat uint8 tensor of float32s)."""
    x = field.view(torch.float32)
    rng = float((x.max() - x.min()).item())
    return max(spec["rel_to_range"] * rng, float(np.finfo(np.float32).tiny))


def codec_overrides(field: torch.Tensor, spec: dict) -> dict:
    return {"lossy_eb": bound(field, spec)}


def control(fields: torch.Tensor, spec: dict, symbol_size: int) -> torch.Tensor:
    x = fields.view(torch.float32)
    return x.to(torch.bfloat16).to(torch.float32).view(torch.uint8)


def compare(field: torch.Tensor, out: torch.Tensor, spec: dict) -> dict:
    """``field`` and ``out`` are flat uint8 tensors on one device."""
    if out.numel() != field.numel():
        return {"max_err_over_eb": float("inf"), "off_grid": field.numel() // 4}
    eb32 = np.float32(bound(field, spec))
    eb2 = np.float32(2.0) * eb32
    x = field.view(torch.float32)
    y = out.view(torch.float32)
    q = prequant(x, np.float32(1.0) / eb2).to(torch.int32)
    recon = q.to(torch.float32) * torch.tensor(eb2, dtype=torch.float32, device=x.device)
    xb, yb, rb = x.view(torch.int32), y.view(torch.int32), recon.view(torch.int32)
    off_grid = int(((yb != xb) & (yb != rb)).sum())
    err = (y.to(torch.float64) - x.to(torch.float64)).abs().max()
    return {"max_err_over_eb": float(err) / float(eb32), "off_grid": off_grid}
