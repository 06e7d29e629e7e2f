"""The data generator: the same seed gives the same fields, on any seed
the driver may pass."""

from __future__ import annotations

import random

import pytest
import torch

from bench.gen import hurricane2d

SPEC = dict(rows=40, cols=80, fields=3, pool_seed=2026, quant_rel_eb=1e-3, lorenzo_ndim=2)
SEEDS = [0, 1, 2**31 - 1, 2**31 + 12345, 3_000_000_001, 2**63 + 5]


@pytest.mark.parametrize("form", ["quant_codes", "f32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_fields(form, seed):
    a = hurricane2d.make(dict(SPEC, form=form), seed, "cpu")
    b = hurricane2d.make(dict(SPEC, form=form), seed, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (3, 40 * 80 * (2 if form == "quant_codes" else 4))
    assert torch.equal(a, b)
    assert not torch.equal(a[0], a[1])  # the pool's fields differ


@pytest.mark.parametrize("form", ["quant_codes", "f32"])
def test_other_seed_other_fields(form):
    a = hurricane2d.make(dict(SPEC, form=form), 7, "cpu")
    b = hurricane2d.make(dict(SPEC, form=form), 8, "cpu")
    assert not torch.equal(a, b)


def test_codes_are_the_dual_quant_of_the_field():
    f = hurricane2d.raw_field(40, 80, hurricane2d.field_seed(2026, 0), "cpu")
    codes = hurricane2d.quant_codes(f, 1e-3, 2)
    eb = 1e-3 * hurricane2d.value_range(f)
    q = torch.round(f / torch.tensor(2 * eb, dtype=torch.float32)).to(torch.int64)
    # the 2-D Lorenzo delta undone: cumulative sums along both axes
    back = torch.cumsum(torch.cumsum(codes.to(torch.int64) - hurricane2d.CENTER, 0), 1)
    assert torch.equal(back, q)
    assert int(codes.min()) >= 0 and int(codes.max()) <= 0xFFFF


@pytest.mark.parametrize("seed", [5, 2**40 + 1])
def test_a_seed_orders_and_shifts_the_pools_fields(seed):
    rng = random.Random(seed)
    order = list(range(3))
    rng.shuffle(order)
    shifts = [rng.randrange(40) for _ in range(3)]
    stored = hurricane2d.make(dict(SPEC, form="quant_codes"), seed, "cpu")
    for k in range(3):
        f = hurricane2d.raw_field(40, 80, hurricane2d.field_seed(2026, order[k]), "cpu")
        codes = hurricane2d.quant_codes(torch.roll(f, shifts[k], dims=0), 1e-3, 2)
        assert torch.equal(stored[k].view(torch.int16).to(torch.int32) & 0xFFFF,
                           codes.reshape(-1))


def test_every_seed_holds_the_same_values():
    a = hurricane2d.make(dict(SPEC, form="f32"), 11, "cpu").view(torch.float32)
    b = hurricane2d.make(dict(SPEC, form="f32"), 12, "cpu").view(torch.float32)
    assert not torch.equal(a, b)
    assert torch.equal(torch.sort(a.reshape(-1)).values, torch.sort(b.reshape(-1)).values)
