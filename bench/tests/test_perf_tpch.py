"""The TPC-H ``lineitem`` generator against the rules of Clause 4.2.3 it
follows, at the tests' small size: the sparse order keys, the lines of an
order, the key and price formulas, every range and date offset, and the
seed's order and shift of the columns."""

from __future__ import annotations

import random

import pytest
import torch

from bench import manifest
from bench.gen import tpch_lineitem as tpch

ROWS = 6000
SEEDS = [0, 2**31 + 12345, 3_000_000_001, 2**63 + 5]


@pytest.fixture(scope="module")
def spec():
    full = manifest.config(manifest.load(), "tpch-lineitem-i32")["data"]
    return tpch.small(full, elements=ROWS, fields=len(full["columns"]))


@pytest.fixture(scope="module")
def cols(spec):
    return {k: v.to(torch.int64) for k, v in tpch.table(spec, "cpu")}


def _orders(cols):
    """(order index of each line, lines of each order) from the keys."""
    key = cols["l_orderkey"]
    starts = torch.ones_like(key, dtype=torch.bool)
    starts[1:] = key[1:] != key[:-1]
    idx = torch.cumsum(starts.to(torch.int64), 0) - 1
    return idx, torch.bincount(idx)


def test_the_configuration_is_sf10_lineitem(spec):
    full = manifest.config(manifest.load(), "tpch-lineitem-i32")
    assert full["data"]["rows"] == 59_986_052 and full["data"]["scale_factor"] == 10
    assert tuple(full["data"]["columns"]) == tpch.COLUMNS
    assert full["codec"]["symbol_size"] == 4 and full["reduced"] == []
    assert spec["rows"] == ROWS and spec["scale_factor"] == 0.01


def test_order_keys_are_sparse_and_orders_have_one_to_seven_lines(cols):
    idx, lines = _orders(cols)
    j = torch.arange(lines.numel())
    keys = cols["l_orderkey"][torch.cumsum(lines, 0) - lines]
    assert torch.equal(keys, 32 * (j // 8) + j % 8 + 1)  # in key order, 8 of each 32 used
    assert int(lines[:-1].min()) >= 1 and int(lines[:-1].max()) <= 7
    assert 1 <= int(lines[-1]) <= 7  # the last order may be cut
    assert set(lines[:-1].tolist()) == set(range(1, 8))
    assert int(lines.sum()) == ROWS


def test_line_numbers_count_one_to_k_within_an_order(cols):
    idx, lines = _orders(cols)
    first = (torch.cumsum(lines, 0) - lines)[idx]
    assert torch.equal(cols["l_linenumber"], torch.arange(ROWS) - first + 1)


def test_an_order_has_one_date(cols):
    idx, lines = _orders(cols)
    od = cols["o_orderdate"]
    assert torch.equal(od[(torch.cumsum(lines, 0) - lines)[idx]], od)  # its first line's


def test_ranges(spec, cols):
    sf = spec["scale_factor"]
    want = {
        "l_partkey": (1, round(sf * 200_000)),
        "l_suppkey": (1, round(sf * 10_000)),
        "l_linenumber": (1, 7),
        "l_discount": (0, 10),
        "l_tax": (0, 8),
        "o_orderdate": (tpch.START_DATE, tpch.END_DATE - 151),
    }
    for name, (lo, hi) in want.items():
        assert int(cols[name].min()) >= lo and int(cols[name].max()) <= hi, name
        assert int(cols[name].min()) == lo or name == "o_orderdate", name
    q = cols["l_quantity"]
    assert torch.equal(q % 100, torch.zeros_like(q))  # hundredths of whole units
    assert set((q // 100).tolist()) == set(range(1, 51))
    assert tpch.START_DATE == 8035 and tpch.END_DATE == 10591  # 1992-01-01, 1998-12-31


def test_supplier_and_price_formulas(spec, cols):
    p = cols["l_partkey"]
    s = round(spec["scale_factor"] * 10_000)
    i = [(p + k * (s // 4 + (p - 1) // s)) % s + 1 for k in range(4)]
    hit = torch.stack([cols["l_suppkey"] == x for x in i])
    assert bool(hit.any(0).all())
    assert bool(hit.sum(1).gt(0).all())  # each of the four suppliers is drawn
    retail = 90_000 + (p // 10) % 20_001 + 100 * (p % 1_000)
    assert torch.equal(cols["l_extendedprice"], cols["l_quantity"] // 100 * retail)


def test_date_offsets(cols):
    od, ship = cols["o_orderdate"], cols["l_shipdate"]
    for name, base, lo, hi in (("l_shipdate", od, 1, 121), ("l_commitdate", od, 30, 90),
                               ("l_receiptdate", ship, 1, 30)):
        d = cols[name] - base
        assert int(d.min()) == lo and int(d.max()) == hi, name


@pytest.mark.parametrize("seed", SEEDS)
def test_a_seed_orders_and_shifts_the_columns(spec, cols, seed):
    a = tpch.make(spec, seed, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (11, ROWS * 4)
    assert torch.equal(a, tpch.make(spec, seed, "cpu"))  # the same seed, the same bytes
    rng = random.Random(seed)
    names = list(spec["columns"])
    rng.shuffle(names)
    shifts = [rng.randrange(ROWS) for _ in names]
    for k, name in enumerate(names):
        got = a[k].view(torch.int32).to(torch.int64)
        assert torch.equal(got, torch.roll(cols[name], shifts[k])), name


def test_other_seeds_other_bytes_same_values(spec):
    a, b = tpch.make(spec, 7, "cpu"), tpch.make(spec, 8, "cpu")
    assert not torch.equal(a, b)
    va, vb = (torch.sort(x.view(torch.int32).reshape(-1)).values for x in (a, b))
    assert torch.equal(va, vb)


def test_small_keeps_the_first_columns(spec):
    two = tpch.small(spec, elements=500, fields=2)
    assert two["columns"] == ["l_orderkey", "l_partkey"] and two["rows"] == 500
    assert tpch.make(two, 3, "cpu").shape == (2, 2000)
    with pytest.raises(ValueError):
        tpch.make(dict(two, form="f32"), 3, "cpu")
