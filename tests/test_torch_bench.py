"""The port's Fig. 8-10 twins against the reference, on the CPU.

``repro_torch.benchmarks`` mirrors the reference's ``benchmarks/fig8_ratio.py``,
``fig9_throughput.py`` and ``fig10_decode.py``: the same rows, flags and
JSON keys under the registry's name map (``xla`` -> ``torch``,
``xla-parallel`` -> ``torch-parallel``, ``xla-scan`` -> ``torch-scan``,
``pallas-match`` -> ``cuda-match``).  Ratios and LZ4 sizes are exact
(tolerance: equality to the last bit); times are not checked here (the
plain versions run on the CPU and their times say nothing of the card).
The twins write only ``BENCH_torch_*.json`` names, here under ``tmp_path``.
"""

import json
import pathlib

import numpy as np
import pytest

from repro.core import lzss as jlzss
from repro.core import pipeline as jpipe
from repro.data import datasets as jdatasets
from repro_torch.benchmarks import common, fig8_ratio, fig9_throughput, fig10_decode
from repro_torch.benchmarks import lz4_format
from repro_torch.core import lzss as tlzss

from _torch_threads import _one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"
NAME_MAP = {"xla": "torch", "xla-parallel": "torch-parallel", "xla-scan": "torch-scan",
            "pallas-match": "cuda-match"}


def _mapped(keys):
    return sorted(NAME_MAP.get(k, k) for k in keys)


@pytest.fixture(scope="module")
def ratio_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("fig8") / "BENCH_torch_ratio.json"
    rec = fig8_ratio.run(nbytes=131072, sweep_nbytes=65536, out_json=str(out), device=CPU)
    assert json.loads(out.read_text()) == rec
    return rec


def test_fig8_ratios_equal_reference_and_tracked_record(ratio_record):
    tracked = json.loads((ROOT / "BENCH_ratio.json").read_text())
    data = jdatasets.load("hurr-quant", 131072)[:65536]
    ref = jlzss.compress(data, jpipe.LZSSConfig(backend="xla")).ratio
    assert ref == 2.431491856194116
    for key, entry in tracked["backends"].items():
        got = ratio_record["backends"][NAME_MAP.get(key, key)]
        assert got["ratio"] == entry["ratio"], key
        assert got["total_bytes"] == entry["total_bytes"], key
    for key, entry in ratio_record["backends"].items():
        want = 3.5259052025609297 if key == "deflate-full" else ref
        assert entry["ratio"] == want, key
        assert entry["orig_bytes"] == entry["nbytes"] == 65536
    assert ratio_record["deflate_full_over_fused_mono"] == tracked["deflate_full_over_fused_mono"]


def test_fig8_keys_equal_reference_under_the_name_map(ratio_record):
    tracked = json.loads((ROOT / "BENCH_ratio.json").read_text())
    assert sorted(ratio_record["backends"]) == _mapped(tracked["backends"])
    lossless = [b for b in jlzss.available_backends() if jpipe.container_method(b) != 2]
    assert sorted(ratio_record["backends"]) == _mapped(lossless)
    assert "sharded" in ratio_record["backends"]
    gains = {k for k in tracked if k.endswith("_over_fused_mono")}
    mapped = {k.replace("pallas_match", "cuda_match").replace("xla_scan", "torch_scan")
              .replace("xla_", "torch_") for k in gains}
    assert {k for k in ratio_record if k.endswith("_over_fused_mono")} == mapped
    assert ratio_record["benchmark"] == tracked["benchmark"]
    assert ratio_record["platform"] == CPU and ratio_record["interpret_mode"] is True
    assert set(tracked) - gains <= set(ratio_record)


def test_registries_map_onto_the_reference():
    assert _mapped(jlzss.available_backends()) == sorted(tlzss.available_backends())
    assert _mapped(jlzss.available_decoders()) == sorted(tlzss.available_decoders())


def _lz4_inputs():
    rng = np.random.default_rng(0)
    return [
        np.zeros(5, np.uint8),
        np.arange(4000, dtype=np.uint16),
        np.repeat(rng.integers(0, 9, 5000), rng.integers(1, 12, 5000)).astype(np.uint8),
        rng.integers(0, 256, 3000).astype(np.uint8),
        jdatasets.load("tpch-string", 1 << 15),
    ]


@pytest.mark.parametrize("i", range(5))
def test_lz4_size_equals_reference(i):
    import benchmarks.lz4_format as jlz4

    x = _lz4_inputs()[i]
    assert lz4_format.lz4_compressed_size(x) == jlz4.lz4_compressed_size(x)
    assert lz4_format.lz4_compressed_size(x, 1000) == jlz4.lz4_compressed_size(x, 1000)
    assert lz4_format.lz4_ratio(x) == jlz4.lz4_ratio(x)


def test_fig9_writes_its_schema(tmp_path, capsys):
    out = tmp_path / "BENCH_torch_pipeline.json"
    rec = fig9_throughput.run(nbytes=16384, sweep_nbytes=16384, out_json=str(out), device=CPU)
    assert json.loads(out.read_text()) == rec
    tracked = json.loads((ROOT / "BENCH_pipeline.json").read_text())
    assert rec["benchmark"] == tracked["benchmark"] == "fig9_backend_sweep"
    assert sorted(rec["backends"]) == _mapped(tracked["backends"])
    assert {k for k in rec if k.endswith("_over_torch")} == {
        k.replace("_over_xla", "_over_torch") for k in tracked if k.endswith("_over_xla")}
    for entry in rec["backends"].values():
        assert set(entry) == {"seconds_per_call", "gb_per_s", "nbytes"}
        assert entry["nbytes"] == jdatasets.load("hurr-quant", 16384).size
        assert entry["seconds_per_call"] > 0
    rows = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("fig9/")]
    names = [r.split(",")[0] for r in rows]
    assert names[:4] == ["fig9/hurr-quant/gpulz", "fig9/hurr-quant/gpulz-best-speed",
                         "fig9/hurr-quant/culzss-workflow", "fig9/hurr-quant/speedup-vs-culzss"]
    assert all(len(r.split(",")) == 3 for r in rows)


def test_fig9_backend_choice(tmp_path):
    rec = fig9_throughput.run(nbytes=8192, sweep_nbytes=8192, backend="cuda-match",
                              out_json=str(tmp_path / "p.json"), device=CPU)
    assert sorted(rec["backends"]) == ["cuda-match", "torch"]
    assert set(rec) >= {"cuda_match_over_torch"}


def test_fig10_writes_its_schema(tmp_path):
    out = tmp_path / "BENCH_torch_decode.json"
    rec = fig10_decode.run(nbytes=16384, sweep_nbytes=16384, out_json=str(out), device=CPU)
    assert json.loads(out.read_text()) == rec
    tracked = json.loads((ROOT / "BENCH_decode.json").read_text())
    assert rec["benchmark"] == tracked["benchmark"] == "fig10_decoder_sweep"
    assert sorted(rec["decoders"]) == _mapped(tracked["decoders"])
    assert {k for k in rec if k.endswith("_over_torch_parallel")} == {
        k.replace("xla_scan", "torch_scan").replace("_over_xla_parallel", "_over_torch_parallel")
        for k in tracked if k.endswith("_over_xla_parallel")}
    assert set(tracked) - {k for k in tracked if k.endswith("_over_xla_parallel")} <= set(rec)
    data = jdatasets.load("hurr-quant", 16384)
    ref = jlzss.compress(data, jpipe.LZSSConfig())
    assert rec["container_bytes"] == ref.total_bytes and rec["ratio"] == ref.ratio


def test_time_fn_and_platform_fields():
    calls = []
    t = common.time_fn(lambda: calls.append(1), warmup=2, iters=3)
    assert len(calls) == 5 and t >= 0
    assert common.platform_fields(CPU) == {"platform": CPU, "interpret_mode": True}
    assert common.throughput_gbs(2e9, 2.0) == 1.0


def test_twins_default_to_untracked_names():
    import inspect

    for mod, name in ((fig8_ratio, "ratio_sweep"), (fig9_throughput, "backend_sweep"),
                      (fig10_decode, "decoder_sweep")):
        default = inspect.signature(getattr(mod, name)).parameters["out_json"].default
        assert default.startswith("BENCH_torch_") and default.endswith(".json")
        assert inspect.signature(mod.run).parameters["out_json"].default == default
