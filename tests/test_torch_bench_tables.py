"""The port's paper-table twins against the reference's benchmarks, on the CPU.

``repro_torch.benchmarks`` mirrors the reference's top-level
``benchmarks/{huffman,table1_ratio,table2_throughput,table3_usecase,
kernel_roofline,fig_lossy,kv_paging,sharded_batch,run}.py``.  Ratios,
Huffman sizes, max errors and containers are exact (equality to the last
bit) where the packages' containers are byte-identical; times are not
checked (the plain versions run here and their times say nothing of the
card).

* table1 / table3: the printed rows equal the reference's (name and derived
  columns) at small sizes; table3's quantization codes are equal too.
* fig_lossy: the sweep's ratios, sizes and max errors equal the tracked
  reference record ``BENCH_lossy.json`` (hurr-field, 64 KiB slice of 1 MiB),
  and its keys equal the record's.
* huffman: sizes equal the reference's estimator's.
* kernel_roofline: the H100 model's rows, ``kernel1_compares`` against a
  Python loop of the per-thread walk, the bound arithmetic.
* sharded_batch: its containers equal the reference's ``compress_many``;
  kv_paging: the record's keys equal the tracked ``BENCH_kv.json``'s and
  paged equals dense at every budget (asserted by the sweep).
* run --quick --only: one suite, at the quick size.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import lzss as jlzss
from repro.data import datasets as jdatasets
from repro_torch.benchmarks import (
    fig_lossy, huffman, kernel_roofline, kv_paging, run as run_twin, sharded_batch,
    table1_ratio, table2_throughput, table3_usecase)
from repro_torch.core import lzss
from repro_torch.kernels import ops
from repro_torch.launch import roofline

jhuffman = pytest.importorskip("benchmarks.huffman")
jtable1 = pytest.importorskip("benchmarks.table1_ratio")
jtable3 = pytest.importorskip("benchmarks.table3_usecase")
jsharded = pytest.importorskip("benchmarks.sharded_batch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on the host's cores, and idle threads spinning slow them all."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rows(text: str) -> list:
    """(name, derived) of the CSV rows a twin printed (no timing column)."""
    out = []
    for line in text.splitlines():
        parts = line.split(",")
        if len(parts) == 3 and "/" in parts[0]:
            out.append((parts[0], parts[2]))
    return out


def test_table1_rows_equal_reference(capsys):
    kw = dict(nbytes=16384, chunks=(2048,), windows=(128,), symbols=(2,))
    rows = table1_ratio.run(device=CPU, **kw)
    ours = _rows(capsys.readouterr().out)
    jtable1.run(**kw)
    assert ours == _rows(capsys.readouterr().out)
    assert len(ours) == len(rows) == len(jdatasets.DATASETS)
    data = jdatasets.load("hurr-quant", 16384)
    want = jlzss.compress(data, jlzss.LZSSConfig(symbol_size=2, window=128, backend="xla")).ratio
    assert rows["table1/hurr-quant/C2048/W128/S2"][1] == want


def test_table2_rows_and_decompress():
    rows = table2_throughput.run(nbytes=8192, device=CPU)
    assert list(rows)[:2] == ["table2/nyx-quant/C2048/W32/S1", "table2/nyx-quant/C2048/W32/S2"]
    assert len(rows) == 25 and list(rows)[-1] == "table2/nyx-quant/decompress"
    assert all(s > 0 and gbs > 0 for s, gbs in rows.values())


def test_table3_rows_and_codes_equal_reference(capsys):
    rows = table3_usecase.run(nbytes=16384, device=CPU)
    ours = _rows(capsys.readouterr().out)
    jtable3.run(nbytes=16384)
    ref = _rows(capsys.readouterr().out)
    keep = [r for r in ours if "throughput" not in r[0]]
    assert keep == [r for r in ref if "throughput" not in r[0]]
    assert len(rows) == 13
    import jax.numpy as jnp

    from repro.core import quant as jquant

    for name, (field, ndim) in table3_usecase.fields(16384).items():
        field = field.astype(np.float32)
        eb = jquant.relative_error_bound(field, 1e-2)
        want = np.asarray(jquant.quantize(jnp.asarray(field), error_bound=eb, ndim=ndim).codes)
        got = table3_usecase.quant_codes(field, 1e-2, ndim, CPU)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("seed", [0, 1])
def test_huffman_sizes_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for data in (rng.integers(0, 7, 5000).astype(np.uint16),
                 rng.normal(size=3000).astype(np.float32),
                 np.zeros(100, np.uint8)):
        assert huffman.huffman_compressed_bytes(data) == jhuffman.huffman_compressed_bytes(data)
        assert huffman.huffman_ratio(data) == jhuffman.huffman_ratio(data)


def test_fig_lossy_equals_tracked_reference_record(tmp_path):
    tracked = json.loads((ROOT / "BENCH_lossy.json").read_text())
    out = tmp_path / "BENCH_torch_lossy.json"
    rec = fig_lossy.run(nbytes=1 << 20, sweep_nbytes=1 << 16, out_json=str(out), device=CPU)
    assert json.loads(out.read_text()) == rec
    assert set(rec) == set(tracked)
    assert rec["platform"] == CPU and rec["interpret_mode"] is True
    for key, entry in tracked["ebs"].items():
        got = rec["ebs"][key]
        assert set(got) == set(entry)
        for k in ("eb", "ratio", "total_bytes", "orig_bytes", "nbytes", "max_abs_err",
                  "bound_ok"):
            assert got[k] == entry[k], (key, k)
    for key in tracked:
        if key.endswith("_over_lossless"):
            assert rec[key] == tracked[key]


def _walk_compares(sym: np.ndarray, window: int) -> int:
    """The per-thread far-to-near walk, position by position."""
    total = 0
    nc, c = sym.shape
    for k in range(nc):
        x = sym[k]
        for i in range(c):
            best = 0
            for d in range(min(i, window), 0, -1):
                cap = min(d, 255, c - i)
                if cap <= best:
                    continue
                total += 1
                if x[i] != x[i - d]:
                    continue
                run = 1
                while run < cap and x[i + run] == x[i - d + run]:
                    run += 1
                total += min(run, cap - 1)
                best = max(best, run)
    return total


@pytest.mark.parametrize("window", [4, 16])
def test_kernel1_compares_equal_the_walk(window):
    rng = np.random.default_rng(window)
    sym = rng.integers(0, 3, (2, 64)).astype(np.int32)
    sym[1, 20:50] = 1  # a long run: capped matches
    assert kernel_roofline.kernel1_compares(torch.from_numpy(sym), window, 64) == \
        _walk_compares(sym, window)


def test_kernel_bytes_ops_cover_every_kernel_and_bound():
    for name in ops.KERNELS:
        nbytes, nops = kernel_roofline.kernel_bytes_ops(
            name, nc=4, c=2048, cap=100, compares=10, flag_bytes=1, payload_bytes=2, length=3,
            nbits=4, nsub=5, n_units=6)
        assert nbytes > 0 and nops > 0, name
    assert kernel_roofline.kernel_bytes_ops("lz_fused_mono", nc=2, c=8, cap=10, compares=7) == (
        4 * 16 + 10 + 16 + 8, 7)
    ms, by = kernel_roofline.bound_ms(int(roofline.HBM_BW), 0)
    assert (ms, by) == (1000.0, "bytes")
    ms, by = kernel_roofline.bound_ms(0, int(roofline.INT32_OPS))
    assert (ms, by) == (1000.0, "operations")


def test_kernel_roofline_rows(capsys):
    rows = kernel_roofline.analytic(nbytes=8192, device=CPU)
    printed = dict(_rows(capsys.readouterr().out))
    for w in kernel_roofline.WINDOWS:
        for s in (1, 2, 4):
            key = f"kernel/analytic/W{w}/S{s}"
            assert rows[key] == min(rows[key + "/compute"], rows[key + "/memory"])
            assert key in printed
    fused = rows["kernel/fused-mono/W64/bytes-per-symbol"]
    n = 64 * 2048
    from repro_torch.core import format as fmt

    assert fused == (4 * n + fmt.max_compressed_bytes(2 * n, 2, 2048) + 8 * 64 + 8) / n
    assert rows["kernel/fused-vs-unfused/hbm-reduction"] == pytest.approx(
        rows["kernel/torch-unfused/W64/bytes-per-symbol"] / fused, rel=1e-12)
    assert rows["kernel/torch-unfused/W64/bytes-per-symbol"] > 100 * fused
    assert rows["kernel/torch-unfused/W64/flops-per-symbol"] > 0


def test_sharded_batch_containers_equal_reference(tmp_path):
    out = tmp_path / "BENCH_torch_sharded.json"
    rec = sharded_batch.main(["--devices", "2", "--buffers", "3", "--nbytes", "8192",
                              "--device", CPU, "--out-json", str(out)])
    assert rec["byte_identical"] is True and rec["n_devices"] == 2
    assert json.loads(out.read_text()) == rec
    items = sharded_batch.corpus(3, 8192)
    assert all(np.array_equal(a, b) for a, b in zip(items, jsharded.corpus(3, 8192)))
    cfg = dict(symbol_size=2, window=64, chunk_symbols=2048)
    ours = lzss.compress_many(items, lzss.LZSSConfig(**cfg), CPU)
    ref = jlzss.compress_many(items, jlzss.LZSSConfig(**cfg, backend="xla"))
    assert np.array_equal(ours.data, np.asarray(ref.data))
    assert ours.total_bytes.tolist() == np.asarray(ref.total_bytes).tolist()


def test_sharded_batch_mesh_of_every_card_needs_one():
    assert sharded_batch.make_mesh(3, CPU) == (torch.device(CPU),) * 3
    assert sharded_batch.make_mesh(0, CPU) == (torch.device(CPU),)


def test_kv_paging_schema_and_exactness(tmp_path):
    tracked = json.loads((ROOT / "BENCH_kv.json").read_text())
    out = tmp_path / "BENCH_torch_kv.json"
    rec = kv_paging.paging_sweep(batch=2, max_len=24, block_tokens=4, prompt_tokens=4,
                                 new_tokens=12, out_json=str(out), device=CPU)
    assert set(rec) == set(tracked)
    assert [set(e) for e in rec["budgets"]] == [set(tracked["budgets"][0])] * len(rec["budgets"])
    assert all(e["exact"] for e in rec["budgets"])
    # the smallest budget evicts and restores; the working set does not
    assert rec["budgets"][0]["evictions"] > 0 and rec["budgets"][-1]["evictions"] == 0
    assert rec["budgets"][-1]["budget_blocks"] == rec["working_set_blocks"]


@pytest.mark.parametrize("only,suite", [("table3", "table3_usecase.run"),
                                        ("fig8", "fig8_ratio.run_paper_table")])
def test_run_quick_only_dispatches_one_suite(monkeypatch, only, suite):
    """``run --quick --only X`` calls X's twin alone, at the quick size, on
    the asked device (the twins' rows are held above)."""
    from repro_torch.benchmarks import fig8_ratio, fig9_throughput

    calls = []
    for mod in (table1_ratio, table2_throughput, table3_usecase, fig9_throughput):
        monkeypatch.setattr(mod, "run", lambda mod=mod, **kw: calls.append(
            (f"{mod.__name__.rsplit('.', 1)[1]}.run", kw)))
    monkeypatch.setattr(fig8_ratio, "run_paper_table",
                        lambda **kw: calls.append(("fig8_ratio.run_paper_table", kw)))
    run_twin.main(["--quick", "--only", only, "--device", CPU])
    assert calls == [(suite, {"nbytes": 1 << 19, "device": CPU})]


def test_twins_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        table1_ratio.run(nbytes=4096)
    with pytest.raises(RuntimeError, match="CUDA"):
        kv_paging.paging_sweep()
