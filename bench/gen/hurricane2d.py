"""The Hurricane ISABEL surrogate, made on the device from the seed.

The same recipe as the surrogate the repository calibrates its ratios on
(a smooth weather field with fronts): on a ``rows x cols`` grid with
``x = col / cols`` and ``y = row / rows``,

    field = 30 sin(6 pi x) cos(4 pi y) + cumsum_cols(N(0, 0.1))

in float32.  ``form`` selects what a field holds:

  * ``"f32"``: the float32 field itself (4 bytes an element);
  * ``"quant_codes"``: cuSZ's dual-quant u16 codes of the field at a
    value-range-relative bound ``quant_rel_eb`` (``eb = rel * (max -
    min)``, ``q = round(x / f32(2 eb))``, a ``lorenzo_ndim``-D Lorenzo
    delta centred at 32768; a delta outside u16 is stored as 32768, as the
    quantizer does for its outliers), 2 bytes an element.

The timestep is a fixed pool of fields, field ``k`` drawn from its own
``torch.Generator`` on the device seeded from ``pool_seed`` and ``k``;
the run's seed picks the order of the fields and a cyclic shift of each
field's rows (before quantization).  So every seed gives other bytes and
the same work: the same values in another order, the same value ranges
and so the same bounds, and the same compressibility up to where the
chunks fall.
"""

from __future__ import annotations

import math
import random

import torch

CENTER = 1 << 15
_MIX = 0x9E3779B97F4A7C15
_INT30 = 2.0**30


def field_seed(pool_seed: int, k: int) -> int:
    """The generator seed of field ``k`` of the pool."""
    return (int(pool_seed) * _MIX + k + 1) % (1 << 63)


def raw_field(rows: int, cols: int, seed: int, device) -> torch.Tensor:
    """(rows, cols) float32: the smooth field plus a noise walk along rows."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    y = torch.arange(rows, dtype=torch.float32, device=device)[:, None] / rows
    x = torch.arange(cols, dtype=torch.float32, device=device)[None, :] / cols
    smooth = torch.sin(6 * math.pi * x) * torch.cos(4 * math.pi * y) * 30
    noise = torch.randn((rows, cols), generator=gen, dtype=torch.float32, device=device)
    return smooth + torch.cumsum(noise * 0.1, dim=1)


def value_range(field: torch.Tensor) -> float:
    """max - min, subtracted in float32."""
    return float((field.max() - field.min()).item())


def quant_codes(field: torch.Tensor, rel_eb: float, ndim: int) -> torch.Tensor:
    """u16 dual-quant codes of ``field`` (as int32 values in [0, 65535])."""
    eb = max(rel_eb * value_range(field), torch.finfo(torch.float32).tiny)
    div = torch.tensor(2.0 * eb, dtype=torch.float32, device=field.device)
    qf = torch.round(field / div)
    nan = torch.isnan(qf)
    q = torch.clamp(torch.where(nan, 0.0, qf), -_INT30, _INT30).to(torch.int32)
    delta = q
    for ax in range(-ndim, 0):
        zero = torch.zeros_like(delta.narrow(ax, 0, 1))
        delta = torch.diff(delta, dim=ax, prepend=zero)
    delta = delta + CENTER
    sat = (delta < 0) | (delta > 0xFFFF) | (qf.abs() >= _INT30) | nan
    return torch.where(sat, CENTER, delta)


def make(spec: dict, seed: int, device) -> torch.Tensor:
    """(fields, n) uint8: each row one field's bytes, little-endian."""
    rows, cols, n_fields = spec["rows"], spec["cols"], spec["fields"]
    form = spec["form"]
    width = {"f32": 4, "quant_codes": 2}[form]
    rng = random.Random(int(seed))
    order = list(range(n_fields))
    rng.shuffle(order)
    shifts = [rng.randrange(rows) for _ in range(n_fields)]
    out = torch.empty((n_fields, rows * cols * width), dtype=torch.uint8, device=device)
    for k in range(n_fields):
        f = raw_field(rows, cols, field_seed(spec["pool_seed"], order[k]), device)
        f = torch.roll(f, shifts[k], dims=0)
        if form == "quant_codes":
            codes = quant_codes(f, spec["quant_rel_eb"], spec["lorenzo_ndim"])
            f = torch.where(codes >= CENTER, codes - (1 << 16), codes).to(torch.int16)
        out[k] = f.reshape(-1).view(torch.uint8)
        del f
    return out
