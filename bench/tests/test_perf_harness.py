"""Whole runs of the harness on the CPU at small sizes: the result's line,
the check (sound, control and faults), the import rule, and a cell added
from files alone.  The card's runs are in ``test_perf_card.py``."""

from __future__ import annotations

import ast
import io
import json
import pathlib
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from _perf_common import CELLS, ROOT, man, small_config  # noqa: F401
from bench import harness

BENCH = ROOT / "bench"
SEED = 3_000_000_017


def _run(man, cell, **kw):
    kw.setdefault("seconds", 0.3)
    kw.setdefault("trace", False)
    return harness.run_cell(man, cell, seed=SEED, device="cpu",
                            config=small_config(man, cell), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(man, cell):
    result, checks = _run(man, cell)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    e2e = {m["name"] for m in man["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    assert set(result["metrics"]) == e2e
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(man, cell):
    result, checks = _run(man, cell, control=True)
    assert not result["correct"]
    assert any(v > lim for _, v, lim in checks)


def _flip_container(monkeypatch):
    from repro_torch.core import lzss

    real = lzss.compress

    def compress(*a, **k):  # a token altered where it is produced
        r = real(*a, **k)
        data = r.data.copy()
        data[data.size - 3] ^= 0x21
        return type(r)(data=data, orig_bytes=r.orig_bytes, total_bytes=r.total_bytes)

    monkeypatch.setattr(lzss, "compress", compress)


def _flip_output(monkeypatch):
    from repro_torch.core import lzss

    real = lzss.decompress

    def decompress(*a, **k):  # an answer altered where it is produced
        out = real(*a, **k).copy()
        out[out.size // 2] ^= 0x10
        return out

    monkeypatch.setattr(lzss, "decompress", decompress)


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(man, cell, monkeypatch):
    (_flip_container if cell.endswith(".write") else _flip_output)(monkeypatch)
    result, checks = _run(man, cell)
    assert not result["correct"], checks


def _main_lines(man, cell, monkeypatch, argv_extra=()):
    """Run ``harness.main`` with its look for a card skipped and the run on
    the CPU at a small size; returns (stdout lines, stderr lines, code)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real = harness.run_cell

    def on_cpu(m, c, **kw):
        return real(m, c, **dict(kw, device="cpu", config=small_config(m, c)))

    monkeypatch.setattr(harness, "run_cell", on_cpu)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = harness.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3",
                             *argv_extra])
    return out.getvalue().splitlines(), err.getvalue().splitlines(), code


@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_has_the_contract_keys(man, monkeypatch, trace):
    cell = "isabel-quant-lz.write"
    out, err, code = _main_lines(man, cell, monkeypatch, ["--trace", str(trace)])
    assert code == 0
    res = json.loads(out[-1])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(res) == want + ["checks"]  # the compared numbers come last
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, v in res["checks"].items():
        assert set(v) == {"value", "limit"}
    tail = [ln for ln in err if ln.startswith("check ")]
    assert err[-len(tail):] == tail and len(tail) == len(res["checks"])


def test_no_card_means_no_result(man, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert code != 0 and capsys.readouterr().out == ""


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_in_bench_imports_jax_or_the_jax_package():
    for src in BENCH.rglob("*.py"):
        bad = _imports(src) & set(harness.FORBIDDEN)
        assert not bad, (src, bad)
    for src in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(src), src
    for src in BENCH.rglob("*.py"):
        if "tests" in src.parts:
            continue
        text = src.read_text()
        assert "BENCH_" not in text and '"benchmarks' not in text, src


def test_a_run_loads_no_forbidden_module(man):
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
        "from bench import harness, manifest\n"
        "sys.path.insert(0, {tests!r}); from _perf_common import small_config\n"
        "m = manifest.load(); c = 'isabel-f32-fz.write'\n"
        "r, _ = harness.run_cell(m, c, seed=5, seconds=0.2, trace=False, device='cpu',"
        " config=small_config(m, c))\n"
        "print(r['correct'], harness.forbidden_modules())\n"
    ).format(root=str(ROOT), src=str(ROOT / "src"), tests=str(BENCH / "tests"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=str(ROOT))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split()[-2:] == ["True", "[]"]


def test_a_cell_added_from_files_alone(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added as
    files and manifest entries only: the copied harness runs them."""
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "isabel-quant-lz.json").read_text())
    cfg.update(name="tiny-quant-w32", codec=dict(cfg["codec"], window=32))
    cfg["data"].update(rows=24, cols=48, fields=2)
    (tmp_path / "bench" / "configs" / "tiny-quant-w32.json").write_text(json.dumps(cfg))
    traffic = dict(op="compress", loop="closed", clients=1, warmup_cycles=2, why="x")
    (tmp_path / "bench" / "traffic" / "write-twice-warm.json").write_text(json.dumps(traffic))
    (tmp_path / "bench" / "metrics" / "calls_per_item.py").write_text(
        "def read(run, variant):\n"
        "    return len(run.calls) / run.fields.shape[0]\n")
    m["configs"].append(dict(name="tiny-quant-w32", source="test", reduced=[], why="test",
                             file="bench/configs/tiny-quant-w32.json"))
    m["workloads"].append(dict(name="tiny.write", config="tiny-quant-w32",
                               traffic="write-twice-warm", chips=1, why="test"))
    for e in m["end_to_end"]:
        if "workloads" in e and "isabel-quant-lz.write" in e["workloads"]:
            e["workloads"].append("tiny.write")
    m["per_layer"].append(dict(name="calls_per_item.any", unit="calls", better="higher",
                               source="host_clock", layer="traffic", moves="compress_GBps",
                               workloads=["tiny.write"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = (
        "import sys, json; sys.path[:0] = [{root!r}, {src!r}]\n"
        "from bench import harness, manifest\n"
        "assert harness.__file__.startswith({root!r})\n"
        "m = manifest.load()\n"
        "for tr in (False, True):\n"
        "    r, _ = harness.run_cell(m, 'tiny.write', seed=5, seconds=0.2, trace=tr,"
        " device='cpu')\n"
        "    print(json.dumps(r))\n"
    ).format(root=str(tmp_path), src=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-2000:]
    plain, traced = (json.loads(ln) for ln in p.stdout.splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert {"compress_GBps", "ratio", "p95_call_ms", "setup_s"} <= set(plain["metrics"])
    assert traced["metrics"]["calls_per_item.any"]["value"] >= 1
    assert np.isfinite(plain["metrics"]["ratio"]["value"])
