"""The port's dry run (repro_torch.launch.dryrun) against the reference, on the CPU.

The reference's meshed dry run does not lower on this jax (its step
builders' ``with_sharding_constraint`` asserts on an Explicit mesh), so the
oracle is its mesh-free unrolled lowering: ``jax.jit`` of
``steps.prefill_step(unroll=True)`` / ``train_step`` with
``TrainConfig(unroll_layers=True)`` / ``decode_step``, with
``models.attention.UNROLL_BLOCKS = True``, and its ``cost_analysis()``: the
count ``_extrapolated_cost`` intends.  The reduced configs at (4, 256), the
port on a 1x1 host mesh.

* The port's GEMM flops (``mm``/``bmm``/``addmm``) equal the sum of 2·m·n·k
  over the dots of the reference's HLO exactly, for every arch and kind
  but mamba2's train step, whose difference is pinned as measured.
* Total flops: within 10% for the dense and MoE transformers in prefill
  and train.  Where the rest differs (mamba2, every decode) the test pins
  the measured ratio (to 0.01): the GEMMs agree exactly, and the gap is
  XLA counting an elementwise op per element of every ``convert`` and of
  the per-block copies of its unrolled attention and SSD chunks (about
  78% of mamba2's non-dot flops are converts), where the eager program
  casts once; in decode the GEMMs are a vector's, so those elementwise
  counts set the ratio.
* Records for the reduced llama3.2-1b, deepseek-v2 and mamba2 x prefill,
  train and decode: the reference's keys plus ``per_device``; bytes at least
  the parameters' bytes.
* Collectives on a 2x2 host mesh (data=2, model=2) and a 2x2x2 mesh equal
  to values reckoned by hand from the reduced llama3.2-1b's shapes and
  specs.
* ``roofline_report`` reads the records (and a record of the reference's).
"""

import functools
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape, TrainConfig as JTrain
from repro.launch import steps as jsteps
from repro.models import attention as jattn, model as jmodel
from repro_torch import configs
from repro_torch.benchmarks import roofline_report
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch import dryrun, mesh as mesh_lib, roofline
from repro_torch.models import model
from repro_torch.optim import grad_compress

from _torch_threads import _one_thread  # noqa: F401

B, T = 4, 256
REF_KEYS = {"arch", "shape", "mesh", "chips", "compressed_grads", "compile_s", "memory",
            "flops_per_device", "bytes_per_device", "collectives", "roofline", "hlo_bytes",
            "direct_scanned_cost"}
# measured ratios (port / reference flops) where they lie outside 10%
PINNED = {
    ("mamba2-2.7b", "prefill"): 0.6241, ("mamba2-2.7b", "train"): 0.6132,
    ("llama3.2-1b", "decode"): 0.6030, ("deepseek-v2-236b", "decode"): 0.7523,
    ("mamba2-2.7b", "decode"): 0.6935,
}


def _ref_compiled(arch, kind):
    cfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    shape = JShape("x", T, B, kind)
    jattn.UNROLL_BLOCKS = True
    try:
        if kind == "prefill":
            fn = jax.jit(functools.partial(jsteps.prefill_step, cfg=cfg, unroll=True))
            return fn.lower(jmodel.abstract_params(cfg), jmodel.input_specs(cfg, shape)).compile()
        if kind == "train":
            tc = JTrain(unroll_layers=True)
            fn = jax.jit(functools.partial(jsteps.train_step, cfg=cfg, traincfg=tc))
            return fn.lower(jsteps.abstract_train_state(cfg, tc),
                            jmodel.input_specs(cfg, shape)).compile()
        fn = jax.jit(functools.partial(jsteps.decode_step, cfg=cfg))
        return fn.lower(jmodel.abstract_params(cfg), jmodel.abstract_cache(cfg, B, T),
                        jmodel.input_specs(cfg, shape)).compile()
    finally:
        jattn.UNROLL_BLOCKS = False


def _dot_flops(hlo: str) -> int:
    """Sum of 2 * output elements * contracted size over the HLO's dots."""
    shapes = {}
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = \w+\[([\d,]*)\]", line)
        if m:
            shapes[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
    total = 0
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?[\w.\-]+ = \w+\[([\d,]*)\]\S* dot\(([^)]*)\)", line)
        if not m:
            continue
        out = 1
        for d in m.group(1).split(","):
            out *= int(d) if d else 1
        lhs = shapes[m.group(2).split(",")[0].strip().split()[-1].lstrip("%")]
        k = 1
        for d in re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line).group(1).split(","):
            k *= lhs[int(d)]
        total += 2 * out * k
    return total


@functools.lru_cache(maxsize=None)
def _reference(arch, kind):
    c = _ref_compiled(arch, kind)
    cost = c.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return float(cost["flops"]), _dot_flops(c.as_text())


def _port_cfg(arch):
    return configs.reduced_config(configs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _port(arch, kind):
    """(record, {op: (calls, flops, bytes)}) of the port's dry run of the
    reduced ``arch`` on a 1x1 host mesh."""
    cfg = _port_cfg(arch)
    m = mesh_lib.make_host_mesh(1, 1, device="cpu")
    rec, _ = dryrun.lower_cell(arch, ShapeConfig(f"x_{kind}", T, B, kind), False, mesh=m,
                               cfg=cfg)
    shape = ShapeConfig("x", T, B, kind)
    with dryrun._mesh_context():
        fn, args, _ = dryrun._step_args(cfg, shape, m, TrainConfig(), False)
        with roofline.CountingMode() as mode:
            fn(*args)
    assert mode.flops == rec["flops_per_device"] * rec["chips"]
    return rec, mode.by_op


ARCHS = ["llama3.2-1b", "deepseek-v2-236b", "mamba2-2.7b"]
KINDS = ["prefill", "train", "decode"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_record_schema_and_bytes(arch, kind):
    rec, _ = _port(arch, kind)
    assert set(rec) == REF_KEYS | {"per_device"}
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes"}
    assert rec["chips"] == 1 and rec["mesh"] == "1x1"
    assert rec["direct_scanned_cost"]["flops"] == rec["flops_per_device"]
    param_bytes = sum(t.numel() * t.element_size()
                      for t in model.abstract_params(_port_cfg(arch)).state_dict().values())
    assert rec["bytes_per_device"] >= param_bytes
    assert rec["memory"]["argument_size_in_bytes"] >= param_bytes
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    json.dumps(rec)  # a record serialises as the reference's does


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_flops_against_reference_unrolled_cost(arch, kind):
    rec, _ = _port(arch, kind)
    ref, _ = _reference(arch, kind)
    ratio = rec["flops_per_device"] * rec["chips"] / ref
    if (arch, kind) in PINNED:
        assert ratio == pytest.approx(PINNED[arch, kind], abs=0.01)
    else:
        assert 0.9 <= ratio <= 1.1, ratio


# mamba2's train step: the reference's dots hold 524,288 flops more (0.08%),
# measured; which backward product XLA writes as a dot is not traced
DOT_EXCESS = {("mamba2-2.7b", "train"): 524_288}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_gemm_flops_equal_reference_dots(arch, kind):
    _, by_op = _port(arch, kind)
    gemm = sum(by_op.get(k, (0, 0, 0))[1] for k in ("mm", "bmm", "addmm", "baddbmm"))
    assert _reference(arch, kind)[1] - gemm == DOT_EXCESS.get((arch, kind), 0)


def _collectives(mesh, compressed=False, kind="train"):
    rec, _ = dryrun.lower_cell("llama3.2-1b", ShapeConfig(f"x_{kind}", 64, 4, kind), False,
                               mesh=mesh, cfg=_port_cfg("llama3.2-1b"), compressed=compressed)
    return rec["collectives"]


# reduced llama3.2-1b, bf16; on data=2, model=2, per device, operand bytes:
# FSDP leaves (spec holds "data") gather their shard twice (forward,
# backward) and reduce-scatter the gradient's data-unsharded piece; the
# norm scales (held whole) reduce-scatter their 64 x 2 bytes and gather the
# ZeRO shard (32 x 2) after the update.
FSDP = {  # name: (shard bytes, data-unsharded piece bytes)
    "embed": (128 * 32 * 2, 128 * 64 * 2),
    "wq": (32 * 2 * 16 * 2, 64 * 2 * 16 * 2), "wk": (32 * 1 * 16 * 2, 64 * 1 * 16 * 2),
    "wv": (32 * 1 * 16 * 2, 64 * 1 * 16 * 2), "wo": (2 * 16 * 32 * 2, 2 * 16 * 64 * 2),
    "wg": (32 * 64 * 2, 64 * 64 * 2), "wu": (32 * 64 * 2, 64 * 64 * 2),
    "wd": (64 * 32 * 2, 64 * 64 * 2),
}
LAYERS, NORMS = 2, 1 + 2 * 2  # ln_f + ln1, ln2 a layer


def test_collectives_on_2x2_host_mesh_by_hand():
    layer = [v for k, v in FSDP.items() if k != "embed"]
    fsdp = [FSDP["embed"]] + layer * LAYERS
    ag = sum(2 * s for s, _ in fsdp) + NORMS * 32 * 2
    rs = sum(p for _, p in fsdp) + NORMS * 64 * 2
    got = _collectives(mesh_lib.make_host_mesh(2, 2, device="cpu"))
    assert got["all-gather"] == ag == 90432
    assert got["reduce-scatter"] == rs == 90752
    assert got["all-reduce"] == got["all-to-all"] == got["collective-permute"] == 0
    assert got["count"] == 2 * len(fsdp) + NORMS + len(fsdp) + NORMS
    assert got["total"] == ag + rs


def test_collectives_on_2x2x2_mesh_add_the_pod_all_reduce():
    layer = [v for k, v in FSDP.items() if k != "embed"]
    fsdp = [FSDP["embed"]] + layer * LAYERS
    pod = sum(s for s, _ in fsdp) + NORMS * 32 * 2  # each device's piece over pod
    m = mesh_lib.make_host_mesh(2, 2, pod=2, device="cpu")
    got = _collectives(m)
    assert got["all-reduce"] == pod == 45376
    assert got["total"] == 90432 + 90752 + pod
    # every piece is under MIN_COMPRESS_SIZE: the compressed exchange sends it raw
    assert _collectives(m, compressed=True) == got


def test_compressed_pieces_send_the_wire(monkeypatch):
    """With MIN_COMPRESS_SIZE at 1024 elements, the embed, wq, wo, wg, wu
    and wd pieces send one slab's wire (2048 symbols: 2048 bytes at
    ratio_cap 2, a flag, a scale; the embed's 4096: 4096 + 5) over pod in
    place of their raw all-reduce; wk, wv and the norms stay raw."""
    monkeypatch.setattr(grad_compress, "MIN_COMPRESS_SIZE", 1024)
    m = mesh_lib.make_host_mesh(2, 2, pod=2, device="cpu")
    got = _collectives(m, compressed=True)
    wires = (4096 + 5) + LAYERS * 5 * (2048 + 5)
    raw = 8192 + LAYERS * (2048 + 2048 + 3 * 4096)
    assert got["all-gather"] == 90432 + wires
    assert got["all-reduce"] == 45376 - raw
    assert got == {**_collectives(m), "all-gather": 90432 + wires,
                   "all-reduce": 45376 - raw, "total": got["total"]}


def test_prefill_gathers_fsdp_shards_once():
    got = _collectives(mesh_lib.make_host_mesh(2, 2, device="cpu"), kind="prefill")
    layer = [v for k, v in FSDP.items() if k != "embed"]
    assert got["all-gather"] == FSDP["embed"][0] + LAYERS * sum(s for s, _ in layer)
    assert got["total"] == got["all-gather"]


@pytest.mark.parametrize("n", [3 * 2048 + 5, 65_536, 3 * (1 << 14) + 5])
def test_wire_bytes_equal_the_exchange(n, monkeypatch):
    """The reckoned wire is the payload, a flag a slab and the scale that
    ``compress_leaf`` sends (slabs of 2^14 symbols here)."""
    monkeypatch.setattr(grad_compress, "SLAB_SYMBOLS", 1 << 14)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    wire = grad_compress.compress_leaf(g, ratio_cap=2.0)
    assert dryrun._wire_bytes(n, 2.0) == (
        wire["payload"].numel() + wire["used_lz"].numel() + 4)


def test_compressed_records_say_the_codec_is_not_counted():
    m = mesh_lib.make_host_mesh(1, 1, pod=2, device="cpu")
    rec, _ = dryrun.lower_cell("llama3.2-1b", ShapeConfig("x_train", 64, 4, "train"), False,
                               mesh=m, cfg=_port_cfg("llama3.2-1b"), compressed=True)
    assert rec["compressed_grads"] is True and "not counted" in rec["codec_work"]


def test_cli_and_report_read_the_records(tmp_path, monkeypatch, capsys):
    real = configs.get_config
    monkeypatch.setattr(dryrun.configs, "get_config", lambda n: configs.reduced_config(real(n)))
    for shape in ("train_4k", "decode_32k"):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "llama3.2-1b", "--shape", shape, "--both-meshes",
                         "--device", "cpu", "--out", str(tmp_path)])
        assert e.value.code == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"llama3.2-1b__{s}__{m}.json" for s in ("decode_32k", "train_4k")
                     for m in ("16x16", "2x16x16")]
    recs = roofline_report.load_records(str(tmp_path))
    assert {r["chips"] for r in recs} == {256, 512}
    table = roofline_report.fmt_table(recs, "16x16")
    assert table.count("| llama3.2-1b |") == 2
    assert "llama3.2-1b x train_4k" in roofline_report.dominant_summary(recs, "2x16x16")
    big = {r["shape"]: r for r in recs if r["mesh"] == "2x16x16"}
    roofline_report.main(["--dir", str(tmp_path), "--mesh", "2x16x16"])
    rows = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("| llama")]
    assert len(rows) == 2
    assert f"{big['train_4k']['roofline']['collective_s']:.3e}" in rows[1]
    # a record of the reference's schema reads the same way
    ref = dict(recs[0], mesh="16x16", arch="ref-arch")
    ref.pop("per_device")
    (tmp_path / "ref.json").write_text(json.dumps(ref))
    roofline_report.main(["--dir", str(tmp_path)])
    assert "| ref-arch |" in capsys.readouterr().out


def test_cli_without_a_card_fails(tmp_path, monkeypatch, capsys):
    real = configs.get_config
    monkeypatch.setattr(dryrun.configs, "get_config", lambda n: configs.reduced_config(real(n)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "[FAIL]" in capsys.readouterr().out


def test_long_500k_is_skipped_by_design(tmp_path, capsys):
    assert dryrun.run_cell("llama3.2-1b", "long_500k", False, str(tmp_path), device="cpu")
    assert "[skip-by-design]" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())
