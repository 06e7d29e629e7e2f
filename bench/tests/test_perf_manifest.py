"""BENCHMARK.json against the benchmark's contract, and every name in it
leading to a file."""

from __future__ import annotations

import json
import re

from _perf_common import man  # noqa: F401
from bench import harness, manifest

CHARS_200 = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def test_top_level_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "bench/run.py"]
    assert man["paths"] == ["bench"]
    assert all(PATH.match(p) and ".." not in p.split("/") for p in man["paths"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man).encode()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters(man):
    names = ([c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    names += [w["config"] for w in man["workloads"]] + [w["traffic"] for w in man["workloads"]]
    names += [k for c in man["configs"] for k in c["reduced"]]
    for n in names:
        assert manifest.NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in man[group]]
        assert len(got) == len(set(got)), group
    for text in ([w["why"] for w in man["workloads"]] + [c["why"] for c in man["configs"]]
                 + [c["source"] for c in man["configs"]] + [m["layer"] for m in man["per_layer"]]):
        assert CHARS_200.match(text), text


def test_entries_have_exactly_the_contract_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_finds_its_files_by_name(man):
    for w in man["workloads"]:
        cfg = manifest.config(man, w["config"])
        assert cfg["name"] == w["config"]
        assert manifest.traffic(w["traffic"])["op"]
        harness.load_module("gen", cfg["data"]["generator"])
        harness.load_module("reference", cfg["guarantee"]["kind"])
        harness.load_module("ops", manifest.traffic(w["traffic"])["op"])
    for c in man["configs"]:
        assert c["file"].startswith("bench/configs/") and c["file"].endswith(f"{c['name']}.json")
        assert c["reduced"] == manifest.config(man, c["name"])["reduced"]


def test_every_metric_has_a_reader(man):
    for m in man["end_to_end"]:
        assert hasattr(harness.load_module("e2e", m["name"]), "read")
    for m in man["per_layer"]:
        assert hasattr(harness.load_module("metrics", m["name"].split(".")[0]), "read")


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(man):
    for w in man["workloads"]:
        e2e = {m["name"] for m in manifest.reported(man, w["name"], trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = manifest.reported(man, w["name"], trace=True)
        assert per_layer
        for m in per_layer:  # a per-layer metric's cells report what it moves
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_the_full_check_fits_its_time_with_24_cells(man):
    runs = 2 + 14 * 24
    assert runs * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
