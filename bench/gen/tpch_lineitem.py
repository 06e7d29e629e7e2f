"""TPC-H ``lineitem``'s integer columns, made on the device from the seed.

The table follows the LINEITEM and ORDERS rules of the TPC-H Standard
Specification v3.0.1, Clause 4.2.3, at scale factor ``scale_factor``
(``SF``), with ``rows`` line items (Clause 4.2.5: 59,986,052 at SF 10).
Orders are taken in key order; order ``j`` gets the sparse key
``32 (j // 8) + (j % 8) + 1`` and 1..7 lines, uniform; the orders stop
once ``rows`` lines are filled, and the last one is cut.  For each line:

    o_orderdate     uniform on [1992-01-01, 1998-12-31 - 151 days], per order
    l_partkey       p uniform on [1, SF 200,000]
    l_suppkey       (p + i (S/4 + (p - 1) / S)) mod S + 1, i uniform on
                    [0, 3], S = SF 10,000 (integer division)
    l_linenumber    1..k within an order of k lines
    l_quantity      uniform on [1, 50]
    l_extendedprice l_quantity x (90000 + (p / 10) mod 20001 + 100 (p mod
                    1000)) hundredths (the part's retail price)
    l_discount      uniform on [0, 10] hundredths; l_tax on [0, 8]
    l_shipdate      o_orderdate + [1, 121]; l_commitdate o_orderdate +
                    [30, 90]; l_receiptdate l_shipdate + [1, 30]

A column is stored as int32 little-endian: keys and counts as they are,
decimals in hundredths (``l_quantity`` 1 is 100), dates as days since
1970-01-01 (Arrow's ``date32``).

The table is a fixed pool, each drawn quantity from its own
``torch.Generator`` on the device seeded from ``pool_seed``; the run's
seed picks the order of the spec's ``columns`` and a cyclic shift of each
column's rows.  So every seed gives other bytes and the same work.  The
bytes differ from ``dbgen``'s (another generator), the distributions are
the same.
"""

from __future__ import annotations

import datetime
import random

import torch

COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
           "l_extendedprice", "l_discount", "l_tax", "l_shipdate", "l_commitdate",
           "l_receiptdate")
_EPOCH = datetime.date(1970, 1, 1)
START_DATE = (datetime.date(1992, 1, 1) - _EPOCH).days
END_DATE = (datetime.date(1998, 12, 31) - _EPOCH).days
ORDER_DATE_MAX = END_DATE - 151
_MIX = 0x9E3779B97F4A7C15
# the drawn quantities, each its own generator (its index is its stream)
_DRAWS = ("lines", "orderdate", "partkey", "supp_i", "quantity", "discount", "tax",
          "ship", "commit", "receipt")


def _uniform(spec, name, lo, hi, n, device) -> torch.Tensor:
    """(n,) int32 uniform on [lo, hi], from the quantity's own generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(spec["pool_seed"]) * _MIX + _DRAWS.index(name) + 1) % (1 << 63))
    return torch.randint(lo, hi + 1, (n,), generator=gen, dtype=torch.int32, device=device)


def table(spec: dict, device):
    """``(name, (rows,) int32)`` of each column of the table in turn, rows
    in order, after ``o_orderdate`` (a line's order's date, not stored).
    Only the quantities that several columns share are held at once."""
    n, sf = int(spec["rows"]), spec["scale_factor"]
    parts, supps = round(sf * 200_000), round(sf * 10_000)
    # an order has at least one line: ``n`` orders always fill ``n`` lines
    lines = _uniform(spec, "lines", 1, 7, n, device)
    ends = torch.cumsum(lines, 0, dtype=torch.int32)
    row = torch.arange(n, dtype=torch.int32, device=device)
    order = torch.searchsorted(ends, row, right=True).to(torch.int32)  # each line's order
    linenumber = row - (ends - lines)[order] + 1
    del lines, ends, row
    orderdate = _uniform(spec, "orderdate", START_DATE, ORDER_DATE_MAX, n, device)[order]
    yield "o_orderdate", orderdate
    yield "l_orderkey", 32 * (order // 8) + order % 8 + 1
    del order
    p = _uniform(spec, "partkey", 1, parts, n, device)
    yield "l_partkey", p
    i = _uniform(spec, "supp_i", 0, 3, n, device)
    yield "l_suppkey", (p + i * (supps // 4 + (p - 1) // supps)) % supps + 1
    del i
    yield "l_linenumber", linenumber
    del linenumber
    quantity = _uniform(spec, "quantity", 1, 50, n, device)
    yield "l_quantity", quantity * 100
    yield "l_extendedprice", quantity * (90_000 + (p // 10) % 20_001 + 100 * (p % 1_000))
    del quantity, p
    yield "l_discount", _uniform(spec, "discount", 0, 10, n, device)
    yield "l_tax", _uniform(spec, "tax", 0, 8, n, device)
    ship = orderdate + _uniform(spec, "ship", 1, 121, n, device)
    yield "l_shipdate", ship
    yield "l_commitdate", orderdate + _uniform(spec, "commit", 30, 90, n, device)
    del orderdate
    yield "l_receiptdate", ship + _uniform(spec, "receipt", 1, 30, n, device)


def layout(spec: dict, seed: int) -> tuple:
    """(the spec's columns in the seed's order, each one's cyclic shift)."""
    names = list(spec["columns"])
    rng = random.Random(int(seed))
    rng.shuffle(names)
    return names, [rng.randrange(int(spec["rows"])) for _ in names]


def make(spec: dict, seed: int, device) -> torch.Tensor:
    """(columns, rows * 4) uint8: each row one int32 column's bytes,
    little-endian, the spec's columns in the seed's order, each shifted."""
    if spec["form"] != "i32":
        raise ValueError(f"tpch_lineitem stores int32 columns, not {spec['form']!r}")
    names, shifts = layout(spec, seed)
    n = int(spec["rows"])
    out = torch.empty((len(names), n * 4), dtype=torch.uint8, device=device)
    for name, col in table(spec, device):
        if name in names:
            k = names.index(name)
            out[k] = torch.roll(col, shifts[k]).view(torch.uint8)
    return out


def small(spec: dict, elements: int, fields: int) -> dict:
    """The spec at the tests' sizes: ``elements`` lines at SF 0.01, the
    first ``fields`` of its columns."""
    return dict(spec, scale_factor=0.01, rows=int(elements), columns=spec["columns"][:fields])
