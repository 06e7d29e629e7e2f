"""The readers of the program's own spans and counters (``bench/spans.py``
and the per-layer metrics on it): the split of idle gaps over nested
program spans on hand-made events, and traced CPU runs of every cell,
whose counters read the card's values and whose stream and idle metrics,
which need the card, read nothing."""

from __future__ import annotations

import sys

import pytest

from _perf_common import CELLS, man, small  # noqa: F401
from bench import devtrace, harness, spans

SEED = 3_000_000_019
CARD_ONLY = ("copy_stream_ms_per_GB", "api_idle_ms_per_GB", "container_stream_ms_per_GB",
             "container_idle_ms_per_GB")


def _events():
    X = lambda cat, name, ts, dur: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)  # noqa: E731
    return [
        X("user_annotation", "bench.call", 100, 100),
        X("user_annotation", "lzss.compress", 102, 96),
        X("user_annotation", "lzss.dispatch", 104, 60),
        X("user_annotation", "lossy.inner", 110, 40),
        X("user_annotation", "entropy.encode", 120, 10),
        X("user_annotation", "lzss.d2h", 170, 25),
        X("cpu_op", "aten::copy_", 171, 20),  # not a program span
        X("kernel", "k", 105, 3),
        X("kernel", "k", 125, 2),
        X("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 180, 10),
    ]


def test_a_gap_is_split_over_nested_program_spans():
    t = devtrace.from_events(_events(), "bench.call")
    assert t.gaps() == [(100.0, 105.0), (108.0, 125.0), (127.0, 180.0), (190.0, 200.0)]
    names = {"lzss.compress", "lzss.dispatch", "lossy.inner", "entropy.encode", "lzss.d2h"}
    progs = [e for e in t.host if e.name in names]
    split = spans.split_gaps(t.gaps(), spans.innermost_segments(progs))
    want = {  # the gaps 100-105, 108-125, 127-180, 190-200, span by span
        None: (102 - 100) + (200 - 198),  # between calls: before and after the root
        "lzss.compress": (104 - 102) + (170 - 164) + (198 - 195),
        "lzss.dispatch": (105 - 104) + (110 - 108) + (164 - 150),
        "lossy.inner": (120 - 110) + (150 - 130),
        "entropy.encode": (125 - 120) + (130 - 127),
        "lzss.d2h": (180 - 170) + (195 - 190),
    }
    assert split.keys() == want.keys()
    for k, v in want.items():
        assert split[k] == pytest.approx(v * 1e-6), k
    assert sum(split.values()) == pytest.approx(sum(e - s for s, e in t.gaps()) * 1e-6)


def test_segments_name_the_innermost_span():
    t = devtrace.from_events(_events(), "bench.call")
    progs = [e for e in t.host if e.name not in ("bench.call", "aten::copy_")]
    segs = spans.innermost_segments(progs)
    assert segs[0] == (102.0, 104.0, "lzss.compress")
    assert (120.0, 130.0, "entropy.encode") in segs
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))  # contiguous


@pytest.fixture
def card_paths(monkeypatch):
    """The card's registry on the CPU (``fused-mono`` both ways, the
    kernels' plain versions): the same sites count as on the card."""
    from repro_torch.core import pipeline

    monkeypatch.setattr(pipeline, "default_backend", lambda device: "fused-mono")
    monkeypatch.setattr(pipeline, "default_decoder", lambda device: "fused-mono")


@pytest.fixture
def runs(monkeypatch):
    """Each ``harness.Run`` a test makes, to read its calls."""
    made = []

    class Recorded(harness.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(harness, "Run", Recorded)
    return made


def expected_counters(run) -> tuple:
    """(copy bytes over field bytes, host syncs a call) of the run's window,
    from what its op declares a call copies and syncs on the card's
    registry (``Op.traced_counts``, keyed by the op and the codec's
    backend)."""
    counts = [run.op.traced_counts(c) for c in run.calls]
    return (sum(b for b, _ in counts) / run.field_bytes(),
            sum(n for _, n in counts) / len(run.calls))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_run_reads_the_programs_counters(man, cell, card_paths, runs):
    from repro_torch.runtime import trace

    result, checks = harness.run_cell(man, cell, seed=SEED, seconds=0.3, trace=True,
                                      device="cpu", **small(man, cell))
    assert result["correct"], checks
    assert not trace.enabled()  # the window's end turned it off
    run = runs[0]
    got = result["metrics"]
    variant = run.op.direction
    copy_bytes, syncs = expected_counters(run)
    assert got[f"copy_bytes_per_field_byte.{variant}"]["value"] == pytest.approx(copy_bytes,
                                                                                 rel=1e-12)
    assert got[f"host_syncs_per_call.{variant}"]["value"] == syncs
    assert not {f"{m}.{variant}" for m in CARD_ONLY} & set(got)


def test_a_program_without_the_tracer_reads_nothing(man, monkeypatch):
    import repro_torch.runtime

    cell = "isabel-quant-lz.read"
    monkeypatch.delattr(repro_torch.runtime, "trace")  # as a parent commit has none:
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)  # import fails
    result, checks = harness.run_cell(man, cell, seed=SEED, seconds=0.2, trace=True,
                                      device="cpu", **small(man, cell))
    assert result["correct"], checks
    new = ("copy_bytes_per_field_byte", "host_syncs_per_call") + CARD_ONLY
    assert not {f"{m}.read" for m in new} & set(result["metrics"])
    assert "launches_per_call.read" in result["metrics"]
