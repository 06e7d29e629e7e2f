"""The port's tracer (repro_torch/runtime/trace.py): off by default and
inert, the span tree of every host-API path, the exact byte and sync
counts each path's sites record, the mirror into ``torch.profiler`` and
the export on its clock, and a scan that every name in the sources is
declared.

The CPU runs take the card's registry (``fused-mono`` both ways, the
kernels' plain versions), so that their counts are the card's.  The
``gpu`` test holds ``host_syncs`` to what the card's sync debug mode
reports:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_trace.py
"""

import json
import pathlib
import re
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import format as fmt, lzss, pipeline
from repro_torch.runtime import trace

from _torch_threads import _one_thread  # noqa: F401

SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
N = 1 << 14  # bytes of a field

C0 = lzss.LZSSConfig(symbol_size=2)
C1 = lzss.LZSSConfig(symbol_size=2, backend="deflate-full")
C2 = lzss.LZSSConfig(symbol_size=4, backend="lossy-fz", lossy_eb=1e-3,
                     lossy_inner="deflate-full")
CONFIGS = {0: C0, 1: C1, 2: C2}
ENTRIES = ("compress", "decompress", "compress_many", "decompress_many")


def _fields(device="cpu"):
    rng = np.random.default_rng(7)
    codes = torch.from_numpy((rng.integers(0, 8, N // 2) + 32760).astype(np.int16))
    x = torch.from_numpy(np.cumsum(rng.normal(size=N // 4)).astype(np.float32))
    x[5] = float("nan")  # one outlier at least
    return {0: codes.to(device), 1: codes.to(device), 2: x.to(device)}


@pytest.fixture
def card_paths(monkeypatch):
    """The card's registry on the CPU: the same sites run as on the card."""
    monkeypatch.setattr(pipeline, "default_backend", lambda device: "fused-mono")
    monkeypatch.setattr(pipeline, "default_decoder", lambda device: "fused-mono")


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


class _Calls:
    """One field a method, its container and a batch of two, made with
    tracing off; ``run(entry, method)`` makes one call of an entry."""

    def __init__(self, device="cpu"):
        self.device = device
        self.fields = _fields(device)
        self.blobs = {m: lzss.compress(f, CONFIGS[m], device=device).data
                      for m, f in self.fields.items()}
        self.batches = {m: lzss.compress_many(self._pair(m), CONFIGS[m], device=device)
                        for m in self.fields}

    def _pair(self, m):
        f = self.fields[m]
        return [f, f[: f.numel() // 2]]

    def run(self, entry, m):
        d = self.device
        if entry == "compress":
            return lzss.compress(self.fields[m], CONFIGS[m], device=d)
        if entry == "decompress":
            return lzss.decompress(self.blobs[m], device=d)
        if entry == "compress_many":
            return lzss.compress_many(self._pair(m), CONFIGS[m], device=d)
        return lzss.decompress_many(self.batches[m], device=d)


@pytest.fixture(scope="module")
def _made():
    return _Calls()  # every raw entry makes the same containers: any registry


@pytest.fixture
def calls(card_paths, _made):
    return _made


def _one_call(tracing, calls, entry, m):
    tracing.reset()
    out = calls.run(entry, m)
    return out, tracing.snapshot()


# ------------------------------------------------------------ tracing off


def test_off_span_is_the_shared_noop_and_nothing_is_recorded(calls):
    trace.disable()
    trace.reset()
    a, b = trace.span("lzss.compress"), trace.span("lossy.inner", "cpu", x=1)
    assert a is b
    with a as sp:
        sp.set(bytes=3)
    trace.count("host_syncs", 5)
    for entry in ENTRIES:
        calls.run(entry, 2)
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["stages"] == {}
    assert all(snap["counters"][k] == 0 for k in trace.COUNTERS)


# ------------------------------------------------------------ the span tree

_CONTAINER_SPANS = {
    ("w", 0): set(),
    ("w", 1): {"entropy.lz", "entropy.histogram", "entropy.code_lengths", "entropy.encode",
               "entropy.assemble"},
    ("r", 0): set(),
    ("r", 1): {"entropy.gap_decode", "entropy.gather", "entropy.lz"},
}
_CONTAINER_SPANS[("w", 2)] = _CONTAINER_SPANS[("w", 1)] | {
    "lossy.quantize", "lossy.bitshuffle", "lossy.inner", "lossy.outliers", "lossy.assemble"}
_CONTAINER_SPANS[("r", 2)] = _CONTAINER_SPANS[("r", 1)] | {
    "lossy.inner", "lossy.unshuffle", "lossy.dequantize"}
_API_SPANS = {
    "w": {"lzss.h2d", "lzss.pack", "lzss.dispatch", "pipeline.totals", "lzss.d2h"},
    "r": {"lzss.validate", "lzss.h2d", "lzss.decode", "lzss.unpack", "lzss.d2h"},
}


@pytest.mark.parametrize("m", [0, 1, 2])
@pytest.mark.parametrize("entry", ENTRIES)
def test_span_tree_of_one_call(tracing, calls, entry, m):
    _, snap = _one_call(tracing, calls, entry, m)
    spans = snap["spans"]
    assert {s["name"] for s in spans} <= set(trace.SPANS)
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == [f"lzss.{entry}"]
    root = roots[0]
    assert {s["call"] for s in spans} == {root["id"]}  # one call id a call
    assert len({s["id"] for s in spans}) == len(spans)
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s is not root:  # a child lies inside its parent
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    way = "r" if entry.startswith("decompress") else "w"
    assert {s["name"] for s in spans} == ({root["name"]} | _API_SPANS[way]
                                          | _CONTAINER_SPANS[(way, m)])
    assert {by_id[s["parent"]]["name"] for s in spans
            if s["name"] in ("lzss.h2d", "lzss.d2h", "lzss.validate")} == {root["name"]}
    if m == 2:  # the entropy stages are the inner lossless stage's
        assert {by_id[s["parent"]]["name"] for s in spans
                if s["name"].startswith("entropy.")} == {"lossy.inner"}
    attrs = root["attrs"]
    assert attrs["method"] == m
    fields = calls.fields[m]
    want = fields.numel() * fields.element_size()
    assert attrs["bytes"] == (want + want // 2 if entry.endswith("_many") else want)
    # no CUDA event on the CPU: no stream time
    assert all(s["stream_ms"] is None for s in spans)
    assert snap["stages"][root["name"]]["count"] == 1


# ------------------------------------------------------------ the counters

# host_syncs of one call on the card's registry, each site beside its count
# (the card's sync debug mode reads the same: the gpu test below)
SYNCS = {
    # lzss.compress on a device field: pipeline.totals 1, lzss.d2h 1 (the
    # header leaves a page-locked block without a wait:
    # format.write_headers_and_tables)
    ("compress", 0): 1 + 1,
    # + the entropy stage: entropy.lz's header read 1, entropy.histogram 1,
    # entropy.encode 2 x (six canonical tables H2D + the bit count read),
    # entropy.assemble's header and metadata H2D 2
    ("compress", 1): 2 + 1 + 1 + 2 * (6 + 1) + 2,
    # + lossy.quantize's two f32 scalars H2D 2, lossy.outliers' nonzero 1,
    # lossy.assemble's metadata H2D 1 (its header as lzss.compress's)
    ("compress", 2): 20 + 2 + 1 + 1,
    # lzss.h2d: container and its A/B tables 3, lzss.d2h 1
    ("decompress", 0): 3 + 1,
    # lzss.h2d: the container 1, entropy.gap_decode's codebook read 1 and
    # 2 x six canonical tables H2D, lzss.d2h 1
    ("decompress", 1): 1 + 1 + 12 + 1,
    # + lossy.inner's two header reads 2, lossy.dequantize's two f32
    # scalars H2D 2 and the outlier mask's index_put_ 1
    ("decompress", 2): 15 + 2 + 2 + 1,
    # two buffers: pipeline.totals 1, lzss.d2h of the batch 1 (the headers
    # as lzss.compress's, one copy for the batch)
    ("compress_many", 0): 1 + 1,
    # each buffer's container alone (19 a buffer), one lzss.d2h
    ("compress_many", 1): 2 * 19 + 1,
    ("compress_many", 2): 2 * 23 + 1,
    # lzss.h2d: the stacked batch and its two tables 3, lzss.d2h a buffer 2
    ("decompress_many", 0): 3 + 2,
    # container by container: 15 a buffer
    ("decompress_many", 1): 2 * 15,
    ("decompress_many", 2): 2 * 20,
}


@pytest.mark.parametrize("entry,m", sorted(SYNCS))
def test_host_syncs_per_path(tracing, calls, entry, m):
    _, snap = _one_call(tracing, calls, entry, m)
    assert snap["counters"]["host_syncs"] == SYNCS[(entry, m)]


_TABLES = 4 * (256 + 256 + 16 + 16 + 16 + 256)  # canonical_tables: six int32 tables


@pytest.mark.parametrize("m", [0, 1, 2])
def test_bytes_of_a_compress(tracing, calls, m):
    r, snap = _one_call(tracing, calls, "compress", m)
    c = snap["counters"]
    totals = 8  # pipeline.totals: one row of two int32
    small_d2h = {0: totals,  # + entropy.lz's header, the histograms, two bit counts
                 1: totals + fmt.HEADER_BYTES + 2 * 256 * 4 + 2 * 8}
    small_d2h[2] = small_d2h[1]
    small_h2d = {0: fmt.HEADER_BYTES,
                 1: fmt.HEADER_BYTES + 2 * _TABLES + fmt.HEADER_BYTES + fmt.ENTROPY_META_FIXED}
    small_h2d[2] = 2 * 4 + small_h2d[1] + fmt.HEADER_BYTES + fmt.LOSSY_META_FIXED
    assert c["bytes_d2h"] == r.total_bytes + small_d2h[m]  # the container, once
    assert c["bytes_h2d"] == small_h2d[m]  # the field is on the device already
    assert c["bytes_host_copy"] == 0


def test_a_host_field_is_one_h2d(tracing, calls):
    field = calls.fields[0].numpy()
    tracing.reset()
    lzss.compress(field, C0, device="cpu")
    c = tracing.snapshot()["counters"]
    assert c["bytes_h2d"] == N + fmt.HEADER_BYTES
    assert c["host_syncs"] == SYNCS[("compress", 0)] + 1


@pytest.mark.parametrize("m", [0, 1, 2])
def test_bytes_of_a_decompress(tracing, calls, m):
    out, snap = _one_call(tracing, calls, "decompress", m)
    c = snap["counters"]
    blob = calls.blobs[m]
    h = fmt.parse_header(blob)
    small_h2d = {0: 8 * h.n_chunks, 1: 2 * _TABLES}  # the A/B tables; the codes' tables
    small_d2h = {0: 0, 1: 256}  # the codebooks
    if m == 2:
        _, _, inner_nc = fmt.lossy_stream_geometry(h.n_chunks, h.chunk_symbols, h.lossy_mode)
        small_h2d[2] = 2 * _TABLES + 2 * 4 + 1  # + two f32 scalars, the mask's True
        small_d2h[2] = 256 + 4 + fmt.HEADER_BYTES + 8 * inner_nc + fmt.ENTROPY_META_FIXED
    assert c["bytes_h2d"] == blob.size + small_h2d[m]  # the container, once
    assert c["bytes_host_copy"] == blob.size  # _validated's writable copy
    assert c["bytes_d2h"] == out.nbytes + small_d2h[m] == N + small_d2h[m]


def test_snapshot_reports_launches_and_stages(tracing, calls):
    _, snap = _one_call(tracing, calls, "compress", 2)
    from repro_torch.kernels import ops

    assert {f"launches.{k}" for k in ops.KERNELS} <= set(snap["counters"])
    st = snap["stages"]
    assert st["entropy.encode"]["count"] == 1 and st["entropy.encode"]["host_ms"] > 0
    assert st["lzss.d2h"]["stream_ms"] is None


def test_a_full_buffer_counts_what_it_drops(tracing, calls, monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 4)
    _, snap = _one_call(tracing, calls, "compress", 2)
    assert len(snap["spans"]) == 4
    assert snap["counters"]["dropped"] == 16 - 4  # a lossy-fz compress has 16 spans


# ------------------------------------------------------------ profiler and export


def test_spans_mirror_into_the_profiler_and_export_on_its_clock(tracing, calls, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        calls.run("compress", 2)
        calls.run("decompress", 2)
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    prof_json = json.loads((tmp_path / "prof.json").read_text())
    marks = sorted((e for e in prof_json["traceEvents"]
                    if e.get("cat") == "user_annotation" and e["name"] in trace.SPANS),
                   key=lambda e: e["ts"])
    spans = sorted(tracing.snapshot()["spans"], key=lambda s: s["start_ns"])
    assert [e["name"] for e in marks] == [s["name"] for s in spans]
    # the same nesting: a span's annotation lies inside its parent's
    mark_of = {s["id"]: e for s, e in zip(spans, marks)}
    for s in spans:
        if s["parent"] is not None:
            p, e = mark_of[s["parent"]], mark_of[s["id"]]
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1
    tracing.export(tmp_path / "spans.json")
    ours = json.loads((tmp_path / "spans.json").read_text())
    assert ours["counters"]["host_syncs"] == SYNCS[("compress", 2)] + SYNCS[("decompress", 2)]
    got = sorted(ours["traceEvents"], key=lambda e: e["ts"])
    assert [e["name"] for e in got] == [s["name"] for s in spans]
    for e, m in zip(got, marks):  # one clock: Unix ns, base + ts us
        ns_ours = ours["baseTimeNanoseconds"] + e["ts"] * 1e3
        ns_prof = prof_json["baseTimeNanoseconds"] + m["ts"] * 1e3
        assert abs(ns_ours - ns_prof) < 1e6, e["name"]


def test_no_mirror_without_a_profiler(tracing, calls, monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    calls.run("compress", 0)
    assert opened == [] and tracing.snapshot()["spans"]


# ------------------------------------------------------------ declared names

_SITE = re.compile(r"trace\.(span|count)\(\s*(\S)")
_NAME = re.compile(r'trace\.(span|count)\(\s*"([^"]+)"')


def test_every_name_in_the_sources_is_declared():
    used = {"span": set(), "count": set()}
    for path in SRC.rglob("*.py"):
        text = path.read_text()
        for kind, first in _SITE.findall(text):
            assert first == '"', f"{path}: a {kind} name that is not a literal"
        for kind, name in _NAME.findall(text):
            used[kind].add(name)
    assert used["span"] == set(trace.SPANS)
    assert used["count"] == set(trace.COUNTERS) - {"dropped"}
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    assert trace.DEVICE_STAGES <= set(trace.SPANS)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the H100; see README)")
    return torch.device("cuda")


def _synchronising_calls(fn) -> int:
    """Warnings of ``torch.cuda.set_sync_debug_mode("warn")`` raised from
    the program's own lines while ``fn`` runs."""
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(1 for w in ws if "synchroniz" in str(w.message).lower()
               and "repro_torch" in w.filename)


@pytest.mark.gpu
@pytest.mark.parametrize("entry,m", sorted(SYNCS))
def test_host_syncs_equal_the_cards_sync_debug_count(cuda, entry, m):
    trace.disable()
    calls = _Calls(device="cuda")
    calls.run(entry, m)  # warm: kernel builds, caches
    torch.cuda.synchronize()
    trace.reset()
    trace.enable()
    try:
        reported = _synchronising_calls(lambda: calls.run(entry, m))
        torch.cuda.synchronize()
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    assert snap["counters"]["host_syncs"] == reported == SYNCS[(entry, m)]
    copies = [s for s in snap["spans"] if s["name"] in ("lzss.h2d", "lzss.d2h")]
    assert copies and all(s["stream_ms"] is not None and s["stream_ms"] >= 0 for s in copies)
