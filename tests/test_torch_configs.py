"""The port's configs, abstract params and logical-axis rules against the
reference's: every field, count, shape, axis and spec is equal (a spec is a
tuple in the port, ``PartitionSpec`` in the reference: ``tuple(P(...))``
is compared)."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import model as jmodel
from repro.sharding import rules as jrules
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.models import common as tcommon, model as tmodel
from repro_torch.sharding import rules as trules

from _torch_threads import _one_thread  # noqa: F401

ARCHS = sorted(jconfigs.ARCHS)


def test_arch_registry_is_the_references():
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)


@pytest.mark.parametrize("name", ARCHS)
def test_config_fields_and_counts(name):
    ref, got = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for padded in (False, True):
        assert got.param_count(padded=padded) == ref.param_count(padded=padded)
    assert got.active_param_count() == ref.active_param_count()
    assert (got.hd, got.padded_heads, got.padded_kv_heads, got.padded_vocab) == (
        ref.hd, ref.padded_heads, ref.padded_kv_heads, ref.padded_vocab)
    if ref.ssm is not None:
        assert (got.ssm_heads, got.padded_ssm_heads) == (ref.ssm_heads, ref.padded_ssm_heads)
    rr, rg = jconfigs.reduced_config(ref), tconfigs.reduced_config(got)
    assert dataclasses.asdict(rg) == dataclasses.asdict(rr)
    assert rg.param_count() == rr.param_count()
    assert rg.active_param_count() == rr.active_param_count()


def test_shapes_cells_and_defaults():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for name in jbase.SHAPES:
        assert dataclasses.asdict(tconfigs.get_shape(name)) == dataclasses.asdict(
            jconfigs.get_shape(name))
    for skipped in (False, True):
        assert list(tconfigs.all_cells(skipped)) == list(jconfigs.all_cells(skipped))
    for arch in ARCHS:
        for shape in jbase.SHAPES:
            assert tconfigs.cell_is_runnable(arch, shape) == jconfigs.cell_is_runnable(arch, shape)
    assert dataclasses.asdict(tbase.TrainConfig()) == dataclasses.asdict(jbase.TrainConfig())
    assert dataclasses.asdict(tbase.CompressionConfig()) == dataclasses.asdict(
        jbase.CompressionConfig())
    assert tbase.MODEL_AXIS == jbase.MODEL_AXIS
    assert [tbase.pad_to(n) for n in range(40)] == [jbase.pad_to(n) for n in range(40)]
    assert [tbase.pad_to(n, 3) for n in range(10)] == [jbase.pad_to(n, 3) for n in range(10)]
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-5")
    with pytest.raises(KeyError):
        tconfigs.get_shape("train_1m")


def _ref_leaves(tree):
    """{dotted key: leaf} of the reference's nested params / axes."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _ref_leaves(v).items()})
        else:
            out[k] = v
    return out


def _port_key_to_ref(key):
    """layers.3.attn.wq -> (layers.attn.wq, True); embed -> (embed, False)."""
    parts = key.split(".")
    if parts[0] == "layers":
        return ".".join(["layers"] + parts[2:]), True
    return key, False


@pytest.mark.parametrize("name", ARCHS)
def test_abstract_params_and_axes_at_full_width(name):
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    ref_shapes = _ref_leaves(jmodel.abstract_params(jcfg))
    ref_axes = _ref_leaves(jmodel.param_axes(jcfg))
    abstract = tmodel.abstract_params(tcfg)
    axes = tmodel.param_axes(tcfg)
    state = abstract.state_dict()
    assert all(t.device.type == "meta" for t in state.values())
    assert set(axes) == set(state)
    seen = set()
    for key, t in state.items():
        rkey, stacked = _port_key_to_ref(key)
        seen.add(rkey)
        shape, raxes = ref_shapes[rkey].shape, ref_axes[rkey]
        if stacked:
            assert shape[0] == jcfg.num_layers and raxes[0] == "layers"
            shape, raxes = shape[1:], raxes[1:]
        assert tuple(t.shape) == tuple(shape), key
        assert str(t.dtype).removeprefix("torch.") == str(ref_shapes[rkey].dtype), key
        assert axes[key] == raxes, key
    assert seen == set(ref_shapes)
    assert sum(t.numel() for t in state.values()) == sum(
        int(np.prod(s.shape)) for s in ref_shapes.values())


@pytest.mark.parametrize("name", ["llama3.2-1b", "hymba-1.5b", "deepseek-v2-236b"])
def test_abstract_caches_and_inputs(name):
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    ref = jmodel.abstract_cache(jcfg, 4, 2048)
    got = tmodel.abstract_cache(tcfg, 4, 2048)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        flat_r, flat_g = _ref_leaves(r), _ref_leaves(g)
        assert set(flat_r) == set(flat_g)
        for k in flat_r:
            assert tuple(flat_g[k].shape) == flat_r[k].shape and flat_g[k].device.type == "meta"
            assert str(flat_g[k].dtype).removeprefix("torch.") == str(flat_r[k].dtype)
    if jcfg.mixer in ("attention", "hybrid"):
        rp = jmodel.abstract_paged_cache(jcfg, 4, 2048, block_tokens=16)
        gp = tmodel.abstract_paged_cache(tcfg, 4, 2048, block_tokens=16)
        for k in ("k", "v"):
            assert tuple(gp["pool"][k].shape) == rp["pool"][k].shape
        assert tuple(gp["tables"].shape) == rp["tables"].shape
    for shape in jbase.SHAPES.values():
        r, g = jmodel.input_specs(jcfg, shape), tmodel.input_specs(tcfg, shape)
        assert set(r) == set(g)
        for k in r:
            assert tuple(g[k].shape) == r[k].shape and g[k].device.type == "meta"
            assert str(g[k].dtype).removeprefix("torch.") == str(r[k].dtype)
    assert tmodel.uses_embedding_frontend(tcfg) == jmodel.uses_embedding_frontend(jcfg)


@pytest.mark.parametrize("name", ARCHS)
def test_make_batch_matches_input_specs(name):
    cfg = tconfigs.reduced_config(tconfigs.get_config(name))
    shape = tbase.ShapeConfig("smoke", 16, 2, "train")
    batch = tmodel.make_batch(cfg, shape, seed=3, device="cpu")
    specs = tmodel.input_specs(cfg, shape)
    assert set(batch) == set(specs)
    for k, t in batch.items():
        assert t.shape == specs[k].shape and t.dtype == specs[k].dtype
    again = tmodel.make_batch(cfg, shape, seed=3, device="cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    if "tokens" in batch:
        assert 0 <= int(batch["tokens"].min()) and int(batch["tokens"].max()) < cfg.vocab_size


def test_dtype_of_and_tree_size():
    cfg = tconfigs.reduced_config(tconfigs.get_config("llama3.2-1b"))
    assert tcommon.dtype_of(cfg) == torch.bfloat16
    assert tcommon.dtype_of(dataclasses.replace(cfg, dtype="float32")) == torch.float32
    m = tmodel.abstract_params(cfg)
    assert tcommon.tree_size_bytes(m) == 2 * sum(t.numel() for t in m.state_dict().values())
    caches = tmodel.abstract_cache(cfg, 2, 32)
    kv = cfg.padded_kv_heads * cfg.hd
    assert tcommon.tree_size_bytes(caches) == cfg.num_layers * (2 * 2 * 32 * kv * 2 + 32 * 4)


# ------------------------------------------------------------ the rules


@pytest.fixture
def rule_state():
    """Restore both packages' rule globals after a test."""
    saved = [(m, m.fsdp_enabled(), m.activation_batch_axes(), m.data_shard_count(),
              m.seq_parallel_enabled()) for m in (jrules, trules)]
    yield
    for m, fsdp, axes, shards, sp in saved:
        m.set_fsdp(fsdp)
        m.set_activation_batch_axes(axes, shards)
        m.set_seq_parallel(sp)


def _spec(p):
    return tuple(p)


def _all_axes():
    out = set()
    for name in ARCHS:
        out.update(tmodel.param_axes(tconfigs.get_config(name)).values())
    return sorted(out)


def test_logical_rules_equal():
    assert trules.LOGICAL_RULES == jrules.LOGICAL_RULES


@pytest.mark.parametrize("fsdp", [True, False])
def test_spec_for_and_compute_spec(rule_state, fsdp):
    jrules.set_fsdp(fsdp)
    trules.set_fsdp(fsdp)
    assert trules.fsdp_enabled() == jrules.fsdp_enabled() == fsdp
    for axes in _all_axes() + [("layers", "embed", "heads"), ("unknown",), ()]:
        assert trules.spec_for(axes) == _spec(jrules.spec_for(axes)), axes
        assert trules.compute_spec(axes) == _spec(jrules.compute_spec(axes)), axes


@pytest.mark.parametrize("name", ["llama3-8b", "hymba-1.5b", "deepseek-v2-236b"])
def test_spec_trees(name):
    ref_axes = jmodel.param_axes(jconfigs.get_config(name))
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    as_tuples = lambda t: jax.tree.map(_spec, t, is_leaf=is_p)  # noqa: E731
    assert trules.params_pspecs(ref_axes) == as_tuples(jrules.params_pspecs(ref_axes))
    for drop in (0, 1):
        assert trules.compute_specs_tree(ref_axes, drop) == as_tuples(
            jrules.compute_specs_tree(ref_axes, drop))
    port_axes = tmodel.param_axes(tconfigs.get_config(name))
    specs = trules.params_pspecs(port_axes)
    assert set(specs) == set(port_axes)
    assert all(specs[k] == trules.spec_for(a) for k, a in port_axes.items())


def _ref_mesh(n):
    """What the reference's spec helpers read of a mesh: axis names and
    sizes (a stand-in: this host has one device)."""
    return types.SimpleNamespace(axis_names=("data", "model"), shape={"data": n, "model": 1})


@pytest.mark.parametrize("n", [1, 2, 4])
def test_zero_and_batch_specs(n):
    mesh = ("cpu",) * n
    rng = np.random.default_rng(n)
    specs = [(), ("data",), ("model",), (None, "model"), ("model", None, None), (("pod", "data"),),
             (None, None), ("model", "data")]
    for spec in specs:
        for _ in range(6):
            shape = tuple(int(x) for x in rng.integers(1, 9, len(spec) + int(rng.integers(0, 2))))
            want = jrules.zero_spec(jax.sharding.PartitionSpec(*spec), shape, _ref_mesh(n))
            assert trules.zero_spec(trules._spec(*spec), shape, mesh) == _spec(want), (spec, shape)
    for b in range(1, 9):
        assert trules.batch_spec(mesh, b) == _spec(jrules.batch_spec(_ref_mesh(n), b))
        assert trules.activation_spec(mesh, b) == _spec(jrules.activation_spec(_ref_mesh(n), b))
    assert trules.batch_axes(mesh) == jrules.batch_axes(_ref_mesh(n)) == ("data",)


def test_activation_context(rule_state):
    for m in (jrules, trules):
        m.set_activation_batch_axes(("pod", "data"), 4)
        m.set_seq_parallel(True)
    assert trules.activation_batch_axes() == jrules.activation_batch_axes() == ("pod", "data")
    assert trules.data_shard_count() == jrules.data_shard_count() == 4
    assert trules.seq_parallel_enabled() and jrules.seq_parallel_enabled()
    for m in (jrules, trules):
        m.set_activation_batch_axes(("data",))
    assert trules.data_shard_count() == jrules.data_shard_count() == 4
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert trules.constrain_batch(x) is x and trules.constrain_batch(x, None, "model") is x
    jx = jax.numpy.arange(24.0).reshape(2, 3, 4)
    assert np.array_equal(np.asarray(jrules.constrain_batch(jx)), x.numpy())
