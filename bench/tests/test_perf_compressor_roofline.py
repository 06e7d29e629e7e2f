"""``compressor_roofline``: the least time of a write window over the
device time of the program's ``fused_mono`` kernels alone, on hand-made
events."""

from __future__ import annotations

import types

import pytest

from bench import devtrace, harness, roofline


def _events():
    X = lambda cat, name, ts, dur: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)  # noqa: E731
    return [
        X("user_annotation", "bench.call", 100, 50),
        X("user_annotation", "bench.call", 160, 40),
        X("kernel", "void (anonymous namespace)::fused_mono<int>(int const*)", 110, 10),
        X("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 115, 10),  # overlaps
        X("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 130, 5),
        X("kernel", "void (anonymous namespace)::fused_mono<int>(int const*)", 50, 10),  # before
    ]


def _write_run(events, compares):
    """A write run of two calls on items 0 and 1, traced as ``events``."""
    run = harness.Run(manifest={}, cell={}, config={}, traffic={}, device="cpu")
    run.op = types.SimpleNamespace(direction="write")
    run.calls = [harness.Call(0, 0.0, 1.0, 4_000_000, 1_000_000),
                 harness.Call(1, 1.0, 2.0, 4_000_000, 3_000_000)]
    run.devtrace = devtrace.from_events(events, "bench.call")
    run.prepared["bench.metrics.kernels_roofline"] = compares
    run.log = lambda msg: None
    return run


def test_compressor_roofline_is_the_bound_over_fused_mono_alone():
    reader = harness.load_module("metrics", "compressor_roofline")
    events = _events()  # fused_mono 10 us in the window; a PyTorch kernel beside it
    least, by = roofline.least_seconds(12_000_000, 3_000_000)
    assert by == "bytes"
    got = reader.read(_write_run(events, [int(2e6), int(1e6)]), "write")
    assert got == pytest.approx(100 * least / 10e-6)
    run = _write_run(events, [int(3e8), int(1e8)])
    assert reader.read(run, "write") == pytest.approx(100 * 4e8 / roofline.INT32_OPS / 10e-6)
    assert reader.read(run, "read") is None


def test_compressor_roofline_reads_nothing_without_the_kernel_or_a_trace():
    reader = harness.load_module("metrics", "compressor_roofline")
    no_compressor = [e for e in _events() if "fused_mono" not in e["name"]]
    assert reader.read(_write_run(no_compressor, None), "write") is None
    run = _write_run(_events(), [int(2e6), int(1e6)])
    run.devtrace = None  # an untraced run
    assert reader.read(run, "write") is None
