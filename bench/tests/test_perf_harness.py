"""Whole runs of the harness on the CPU at small sizes: the result's line,
the check (sound, control and faults), the import rule, and a cell added
from files alone.  The card's runs are in ``test_perf_card.py``."""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from _perf_common import CELLS, ROOT, man, small  # noqa: F401
from bench import harness
from bench.reference import gplz

BENCH = ROOT / "bench"
SEED = 3_000_000_017


def _run(man, cell, **kw):
    kw.setdefault("seconds", 0.3)
    kw.setdefault("trace", False)
    return harness.run_cell(man, cell, seed=SEED, device="cpu", **small(man, cell), **kw)


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


def _flip_container(r):
    """One live byte of one container altered: a token altered where it is
    produced (a ``CompressResult``'s third byte from its end, or the middle
    container of a batch's first literal, since a batch's containers may end
    in tokens of their last chunk's padding)."""
    data = r.data.copy()
    if data.ndim == 1:
        data[data.size - 3] ^= 0x21
    else:
        b = len(r) // 2
        h = gplz.parse_header(data[b, : int(r.total_bytes[b])])
        data[b, h["sec_meta"] + h["flags"]] ^= 0x21
    return dataclasses.replace(r, data=data)


def _flip_output(out):
    """One byte of one output altered: an answer altered where it is
    produced (an array, or the middle one of a list)."""
    if isinstance(out, list):
        out, m = list(out), len(out) // 2
        out[m] = _flip_output(out[m])
        return out
    out = out.copy()
    out[out.size // 2] ^= 0x10
    return out


def _tamper(monkeypatch, man, cell):
    """Patch the ``lzss`` function the cell's timed call goes through (its
    op's ``ENTRY``) to alter what it returns: a write's container, a
    read's output."""
    from repro_torch.core import lzss

    op = harness.load_module("ops", small(man, cell)["traffic"]["op"])
    real = getattr(lzss, op.ENTRY)
    alter = _flip_container if op.Op.direction == "write" else _flip_output
    monkeypatch.setattr(lzss, op.ENTRY, lambda *a, **k: alter(real(*a, **k)))


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(man, cell, monkeypatch):
    _tamper(monkeypatch, man, cell)
    result, checks = _run(man, cell)
    assert not result["correct"], checks


@pytest.mark.parametrize("cycles", (1, 2))
def test_a_traced_window_ends_after_its_traffics_cycles(man, cycles):
    """A traffic's ``traced_cycles`` ends a traced window after that many
    cycles through the items; the untraced window runs its seconds."""
    kw = small(man, "isabel-quant-lz.blocks")
    kw["traffic"] = dict(kw["traffic"], traced_cycles=cycles)
    fields = kw["config"]["data"]["fields"]
    traced, checks = harness.run_cell(man, "isabel-quant-lz.blocks", seed=SEED, seconds=60,
                                      trace=True, device="cpu", **kw)
    assert traced["correct"], checks
    assert traced["attempted"] == cycles * fields
    assert traced["device"]["window_s"] < 60
    plain, checks = harness.run_cell(man, "isabel-quant-lz.blocks", seed=SEED, seconds=0.5,
                                     trace=False, device="cpu", **kw)
    assert plain["correct"], checks
    assert plain["attempted"] > cycles * fields


def _main_lines(man, cell, monkeypatch, argv_extra=()):
    """Run ``harness.main`` with its look for a card skipped and the run on
    the CPU at a small size; returns (stdout lines, stderr lines, code)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real = harness.run_cell

    def on_cpu(m, c, **kw):
        return real(m, c, **dict(kw, device="cpu", **small(m, c)))

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


INT_COLUMNS = """\
import torch


def make(spec, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    x = torch.randint(0, spec["distinct"], (spec["columns"], spec["rows_per_column"]),
                      generator=gen, dtype=torch.int32, device=device)
    return x.view(torch.uint8)


def small(spec, elements, fields):
    return dict(spec, rows_per_column=elements, columns=fields)
"""


def test_a_cell_added_from_files_alone(tmp_path):
    """Two new cells added as files and manifest entries only: a
    configuration, a traffic mix, a cell and a per-layer metric on the
    ``compress`` op; and a generator with keys of its own making int32
    columns (the ``i32`` form), its configuration, and a traffic mix on
    the ``compress_many`` op.  The copied harness runs them, and the
    copy's own parametrised tests pass on both with no copied file
    edited."""
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*") if p.is_file()}
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
    (tmp_path / "bench" / "gen" / "int_columns.py").write_text(INT_COLUMNS)
    ints = dict(name="tiny-i32", source="test", deployment="x",
                data=dict(generator="int_columns", rows_per_column=4096, columns=3,
                          distinct=50, form="i32"),
                codec=dict(symbol_size=4, window=64, chunk_symbols=256),
                guarantee=dict(kind="lossless"), roofline_ops="window_walk_compares", reduced=[])
    (tmp_path / "bench" / "configs" / "tiny-i32.json").write_text(json.dumps(ints))
    batched = dict(op="compress_many", loop="closed", clients=1, buffer_bytes=4096,
                   warmup_cycles=1, why="x")
    (tmp_path / "bench" / "traffic" / "write-batched.json").write_text(json.dumps(batched))
    for name in ("tiny-quant-w32", "tiny-i32"):
        m["configs"].append(dict(name=name, source="test", reduced=[], why="test",
                                 file=f"bench/configs/{name}.json"))
    m["workloads"].append(dict(name="tiny.write", config="tiny-quant-w32",
                               traffic="write-twice-warm", chips=1, why="test"))
    m["workloads"].append(dict(name="tiny-i32.blocks", config="tiny-i32",
                               traffic="write-batched", chips=1, why="test"))
    for e in m["end_to_end"]:
        if "workloads" in e and "isabel-quant-lz.write" in e["workloads"]:
            e["workloads"] += ["tiny.write", "tiny-i32.blocks"]
    for e in m["per_layer"]:
        if "isabel-quant-lz.write" in e.get("workloads", ()):
            e["workloads"] += ["tiny.write", "tiny-i32.blocks"]
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
    # the copy's parametrised tests, on the two new cells alone
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                        "-p", "no:xdist", "-p", "no:randomly", "bench/tests", "-k", "tiny"],
                       capture_output=True, text=True, timeout=600, cwd=str(tmp_path), env=env)
    assert p.returncode == 0, p.stdout[-3000:]
    tail = p.stdout.strip().splitlines()[-1]
    params = ("test_a_sound_run_is_correct", "test_the_control_is_not_correct",
              "test_an_altered_answer_is_not_correct",
              "test_traced_cpu_run_reads_the_programs_counters")
    assert f"{2 * len(params)} passed" in tail and "failed" not in tail, tail
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no copied file was edited
