"""Error-bounded Lorenzo quantization (cuSZ-style) — the paper's §4.5 use case.

The PyTorch counterpart of the reference's ``core/quant.py``, the cuSZ
"dual-quant" scheme:

    q[i]    = round(x[i] / (2 * eb))                (pre-quantization, int32)
    code[i] = q[i] - Lorenzo_pred(q, i) + CENTER    (integer Lorenzo delta)

Reconstruction integrates the deltas (cumsum along each predicted axis) and
multiplies back:  |x' - x| <= eb  for every element within int range.
Codes center at 32768 and saturate to uint16; saturated positions are kept
as exact fp32 outliers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CENTER = 1 << 15
CODE_MIN, CODE_MAX = 0, (1 << 16) - 1


@dataclasses.dataclass(frozen=True)
class QuantResult:
    codes: torch.Tensor         # uint16 values (int32 tensor), input's shape
    outlier_mask: torch.Tensor  # bool
    outlier_vals: torch.Tensor  # fp32, 0 where not outlier
    error_bound: float


def _prequant_float(x: torch.Tensor, error_bound: float) -> torch.Tensor:
    # an elementwise true division by the f32 divisor, as the reference's
    # jnp expression computes it (a scalar divisor may be turned into a
    # multiplication by its reciprocal, which rounds differently)
    div = torch.tensor(2.0 * error_bound, dtype=torch.float32, device=x.device)
    return torch.round(x.to(torch.float32) / div.expand(x.shape))


def _lorenzo_delta(q: torch.Tensor, ndim: int) -> torch.Tensor:
    """q - pred(q): the composition of first differences along each axis."""
    delta = q
    for ax in range(-ndim, 0):
        zero = torch.zeros_like(delta.narrow(ax, 0, 1))
        delta = torch.diff(delta, dim=ax, prepend=zero)
    return delta


def _lorenzo_undelta(d: torch.Tensor, ndim: int) -> torch.Tensor:
    q = d
    for ax in range(-ndim, 0):
        q = torch.cumsum(q, dim=ax, dtype=torch.int32)
    return q


def quantize(x: torch.Tensor, *, error_bound: float, ndim: int = 1) -> QuantResult:
    if ndim < 1 or ndim > min(3, x.dim()):
        raise ValueError(f"ndim must be in [1, {min(3, x.dim())}]")
    qf = _prequant_float(x, error_bound)
    # saturate the pre-quantization to int30; NaN pre-quantizes to 0 and
    # takes the exact outlier path
    nan = torch.isnan(qf)
    q = torch.clamp(torch.where(nan, 0.0, qf), -(2.0 ** 30), 2.0 ** 30).to(torch.int32)
    delta = _lorenzo_delta(q, ndim) + CENTER
    saturated = (delta < CODE_MIN) | (delta > CODE_MAX) | (qf.abs() >= 2.0 ** 30) | nan
    return QuantResult(
        codes=torch.where(saturated, CENTER, delta).to(torch.int32),
        outlier_mask=saturated,
        outlier_vals=torch.where(saturated, x.to(torch.float32), 0.0),
        error_bound=error_bound,
    )


def _encoder_prequant(x: torch.Tensor, error_bound: float) -> torch.Tensor:
    """The exact pre-quant integer quantize() computed for value x."""
    qf = _prequant_float(x, error_bound)
    qf = torch.where(torch.isnan(qf), 0.0, qf)
    return torch.clamp(qf, -(2.0 ** 30), 2.0 ** 30).to(torch.int32)


def dequantize(codes, outlier_mask, outlier_vals, *, error_bound, ndim=1):
    q = _lorenzo_undelta(codes.to(torch.int32) - CENTER, ndim)
    if ndim == 1:
        # Chain repair: an outlier stores code CENTER (delta 0) while the
        # encoder's chain downstream used the true pre-quant, so the raw
        # cumsum is off by a constant after each outlier; the outlier value
        # pins the encoder's pre-quant exactly, and adding q_ref - q_raw of
        # the last outlier at or before each position restores the chain.
        # int32 wraparound in the difference cancels on the add.
        q_ref = _encoder_prequant(outlier_vals, error_bound)
        n = codes.shape[-1]
        idx = torch.arange(n, dtype=torch.int64, device=codes.device).expand(codes.shape)
        last = torch.cummax(torch.where(outlier_mask, idx, -1), dim=-1).values
        adj = torch.where(outlier_mask, q_ref - q, 0)
        carry = torch.gather(adj, -1, torch.clamp(last, min=0))
        q = q + torch.where(last >= 0, carry, 0)
    x = q.to(torch.float32) * torch.tensor(2.0 * error_bound, dtype=torch.float32)
    return torch.where(outlier_mask, outlier_vals, x)


def relative_error_bound(x, rel_eb: float) -> float:
    """Paper uses value-range-relative bounds (e.g. 1e-2, 1e-3)."""
    x = np.asarray(x)
    rng = float(x.max() - x.min()) if x.size else 1.0
    return max(rel_eb * rng, np.finfo(np.float32).tiny)
