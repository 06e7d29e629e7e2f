"""The harness on the card at a small size: a sound run is correct, the
control is not, and the traced run reads every per-layer metric.  Run on
a machine with a card: ``PYTHONPATH=.:src python -m pytest bench/tests -m gpu``."""

from __future__ import annotations

import pytest

from _perf_common import CELLS, card, man, small_config  # noqa: F401
from bench import harness, manifest


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(man, card, cell):
    cfg = small_config(man, cell, rows=500, cols=1000, fields=3)
    kw = dict(seed=3_000_000_021, seconds=1.0, device="cuda", config=cfg)
    plain, checks = harness.run_cell(man, cell, trace=False, **kw)
    assert plain["correct"], checks
    traced, checks = harness.run_cell(man, cell, trace=True, **kw)
    assert traced["correct"], checks
    want = {m["name"] for m in manifest.reported(man, cell, trace=True)}
    assert set(traced["metrics"]) == want
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    control, checks = harness.run_cell(man, cell, trace=False, control=True, **kw)
    assert not control["correct"], checks
