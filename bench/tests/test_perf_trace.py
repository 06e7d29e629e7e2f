"""The device trace's reduction: busy and idle time, the breakdown, the
copy and kernel sums the per-layer readers take, on hand-made events."""

from __future__ import annotations

import pytest

from bench import devtrace


def _events():
    X = lambda cat, name, ts, dur: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)  # noqa: E731
    return [
        X("user_annotation", "bench.call", 100, 50),
        X("user_annotation", "bench.call", 160, 40),
        X("cpu_op", "aten::copy_", 105, 20),
        X("cuda_runtime", "cudaMemcpyAsync", 106, 18),
        X("kernel", "void (anonymous namespace)::fused_mono<int>(int const*)", 110, 10),
        X("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 115, 10),  # overlaps
        X("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 130, 5),
        X("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 170, 20),
        X("gpu_memset", "Memset (Device)", 195, 10),  # runs past the window
        X("kernel", "void at::native::other<1>(int)", 50, 10),  # before the window
        X("gpu_user_annotation", "bench.call", 100, 50),  # a span, not activity
        dict(ph="i", cat="kernel", name="instant", ts=120),
    ]


def test_window_busy_and_gaps():
    t = devtrace.from_events(_events(), "bench.call")
    assert t.window == (100.0, 200.0)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy() == [[110.0, 125.0], [130.0, 135.0], [170.0, 190.0], [195.0, 200.0]]
    assert t.busy_s() == pytest.approx(45e-6)
    assert t.gaps() == [(100.0, 110.0), (125.0, 130.0), (135.0, 170.0), (190.0, 195.0)]


def test_sums_by_kind_and_name():
    t = devtrace.from_events(_events(), "bench.call")
    assert t.seconds(("kernel",)) == pytest.approx(20e-6)
    copies = t.seconds(("memcpy",), lambda n: devtrace.copy_direction(n) in ("HtoD", "DtoH"))
    assert copies == pytest.approx(25e-6)
    own = {"fused_mono", "decode"}
    torch_s = t.seconds(("kernel",), lambda n: not devtrace.is_program_kernel(n, own))
    assert torch_s == pytest.approx(10e-6)


def test_breakdown_names_ops_and_gaps():
    b = devtrace.from_events(_events(), "bench.call").breakdown()
    assert b["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)", pytest.approx(20e-6)]
    assert len(b["device_ops"]) == 5
    # the longest gap starts at 135, after aten::copy_ ended, inside the
    # first call's span; the next at 100, where that span starts
    assert b["idle_gaps"][0] == ["bench.call", pytest.approx(35e-6)]
    assert b["idle_gaps"][1] == ["bench.call", pytest.approx(10e-6)]


def test_innermost_host_op_names_a_gap():
    t = devtrace.from_events(_events(), "bench.call")
    assert t.host_at(107) == "cudaMemcpyAsync"
    assert t.host_at(152) == "host"


def test_program_kernels_are_the_sources_globals():
    names = devtrace.program_kernels()
    assert {"fused_mono", "decode_mono", "gap_decode", "bitshuffle"} <= names
    assert devtrace.is_program_kernel("void (anonymous namespace)::decode_mono<true, 2>(x)", names)
    assert not devtrace.is_program_kernel("void at::native::decode(x)", names)
    assert devtrace.kernel_identity("fused_mono(int)") == ("", "fused_mono")
