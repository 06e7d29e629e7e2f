"""The port's training path (repro_torch.launch.*, runtime.elastic) against
the reference package's, on the CPU, at the reduced llama3.2-1b.

* ``train_step`` against ``repro.launch.steps.train_step`` from the same
  converted f32 state on the same batches (``make_batch_for_step``, equal
  in both packages), over 3 steps past the warm-up.  Losses and gradient
  norms within 1e-4 relative.  Params and both moments within 1e-5 of max
  |reference| per tensor: the two forward and backward passes sum in other
  orders, so gradients differ by f32 rounding (about 1e-7 relative), and
  three AdamW steps carry that into the state (measured: 7.5e-7 for params,
  5.8e-7 for moments).
* microbatches 2 against 1 in the port (the same gradients summed in two
  halves: the same bound), and the loss with 2 against the reference's.
* the loss falls over 25 steps (tests/test_system.py); resume from a
  checkpoint is bit-exact.
* ``train_step_compressed`` over a mesh of two CPU pods: the exchanged
  gradients equal the reference's per-leaf exchange (its ``compress_leaf``
  / ``decompress_leaf`` on each pod's gradients, then the mean) within
  1e-6; the reference's own compressed step does not run on this jax
  (its ``with_sharding_constraint`` asserts on an Explicit mesh).
* ``plan_remesh``, ``restore_onto_mesh``, and ``train.main`` /
  ``serve.main`` with ``--device cpu``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrain
from repro.data.pipeline import DataConfig, make_batch_for_step
from repro.launch import steps as jsteps
from repro.optim import grad_compress as jgc
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import CompressionConfig, ShapeConfig, TrainConfig
from repro_torch.launch import mesh as mesh_lib, serve, steps, train
from repro_torch.models import convert
from repro_torch.runtime import elastic
from repro_torch.sharding import rules

from _torch_model_ref import pair, rel_err

TRAIN = dict(total_steps=10, warmup_steps=1, learning_rate=3e-3)
SEQ, BATCH = 64, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on the host's cores, and idle threads spinning slow them all."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batch(step, cfg, seq=SEQ, batch=BATCH):
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    return make_batch_for_step(dc, step)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _state_rel_err(port_state, ref_state) -> dict:
    """max |port - reference| / max |reference| of every leaf."""
    got = jax.tree_util.tree_flatten_with_path(convert.train_state_to_numpy(port_state))[0]
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref_state))
    return {jax.tree_util.keystr(p): rel_err(a, b) for (p, a), b in zip(got, want)}


@pytest.fixture(scope="module")
def reference_run():
    """The reference's f32 state before and after 3 steps, and its metrics."""
    jcfg, _ = pair("llama3.2-1b")
    jtc = JTrain(**TRAIN)
    start = jsteps.init_train_state(jcfg, jtc, 0)
    fn = jax.jit(lambda s, b: jsteps.train_step(s, b, cfg=jcfg, traincfg=jtc))
    state, metrics = start, []
    for step in range(3):
        state, m = fn(state, _batch(step, jcfg))
        metrics.append({k: float(v) for k, v in m.items()})
    jtc2 = JTrain(microbatches=2, **TRAIN)
    _, m2 = jax.jit(lambda s, b: jsteps.train_step(s, b, cfg=jcfg, traincfg=jtc2))(
        start, _batch(0, jcfg))
    return jax.tree.map(np.asarray, start), jax.tree.map(np.asarray, state), metrics, float(
        m2["loss"])


def _port_state(start):
    _, tcfg = pair("llama3.2-1b")
    return convert.train_state_from_numpy(start, tcfg, device="cpu"), tcfg


def test_train_step_matches_reference(reference_run):
    start, want_state, want_metrics, _ = reference_run
    state, tcfg = _port_state(start)
    tc = TrainConfig(**TRAIN)
    for step in range(3):
        state, m = steps.train_step(state, _torch_batch(_batch(step, tcfg)), cfg=tcfg,
                                    traincfg=tc)
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(m[k]) - want_metrics[step][k]) <= 1e-4 * abs(want_metrics[step][k]), k
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int32
    errs = _state_rel_err(state, want_state)
    assert max(errs.values()) <= 1e-5, errs


def test_microbatches_two_against_one(reference_run):
    start, _, want_metrics, want_mb2_loss = reference_run
    b = _torch_batch(_batch(0, pair("llama3.2-1b")[1]))
    out = {}
    for mb in (1, 2):
        state, tcfg = _port_state(start)
        out[mb] = steps.train_step(state, b, cfg=tcfg, traincfg=TrainConfig(microbatches=mb,
                                                                            **TRAIN))
    (s1, m1), (s2, m2) = out[1], out[2]
    assert set(m2) == {"loss", "grad_norm", "lr"}
    assert abs(float(m2["loss"]) - want_mb2_loss) <= 1e-4 * want_mb2_loss
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-4 * float(m1["loss"])
    a, b2 = convert.train_state_to_numpy(s1), convert.train_state_to_numpy(s2)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b2)):
        assert rel_err(y, x) <= 1e-5


def test_tiny_lm_loss_decreases():
    cfg = configs.reduced_config(configs.get_config("llama3.2-1b"))
    tc = TrainConfig(total_steps=30, warmup_steps=3, learning_rate=3e-3)
    state = steps.init_train_state(cfg, tc, 0, device="cpu")
    losses = []
    for step in range(25):
        state, m = steps.train_step(state, _torch_batch(_batch(step, cfg, 128, 4)), cfg=cfg,
                                    traincfg=tc)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::6]
    assert not any(np.isnan(v) for v in losses)


def test_train_resume_bit_exact(tmp_path):
    cfg = configs.reduced_config(configs.get_config("llama3.2-1b"))
    tc = TrainConfig(total_steps=30, warmup_steps=3, learning_rate=3e-3)

    def run(state, lo, hi):
        for step in range(lo, hi):
            state, _ = steps.train_step(state, _torch_batch(_batch(step, cfg, 128, 4)), cfg=cfg,
                                        traincfg=tc)
        return state

    state_a = run(steps.init_train_state(cfg, tc, 0, device="cpu"), 0, 6)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(run(steps.init_train_state(cfg, tc, 0, device="cpu"), 0, 3), 3)
    restored, start = mgr.restore_latest(steps.abstract_train_state(cfg, tc))
    assert start == 3
    state_b = run(restored, start, 6)
    for a, b in zip(jax.tree.leaves(convert.train_state_to_numpy(state_a)),
                    jax.tree.leaves(convert.train_state_to_numpy(state_b))):
        assert np.array_equal(a, b)


def test_train_step_compressed_two_cpu_pods(monkeypatch):
    # the reduced model's leaves are all under the exchange's 65,536
    # elements: lower the floor so the larger ones go through the codec
    monkeypatch.setattr(steps.grad_compress, "MIN_COMPRESS_SIZE", 4096)
    jcfg, tcfg = pair("llama3.2-1b")
    start = jax.tree.map(np.asarray, jsteps.init_train_state(jcfg, JTrain(**TRAIN), 0))
    state, _ = _port_state(start)
    tc = TrainConfig(compression=CompressionConfig(grad_cross_pod=True), **TRAIN)
    mesh = mesh_lib.make_host_mesh(data=1, model=1, pod=2, device="cpu")
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    fn, st_sh, b_sh = steps.make_train_step(tcfg, tc, mesh, shape, compressed=True)
    assert st_sh["step"].device == torch.device("cpu") and b_sh["tokens"].spec == (
        ("pod", "data"), None)
    seen = {}
    real = steps.grad_compress.pod_exchange_compressed

    def capture(stack, pods, **kw):
        seen.update(stack=stack, pods=pods, kw=kw)
        seen["out"] = real(stack, pods, **kw)
        return seen["out"]

    monkeypatch.setattr(steps.grad_compress, "pod_exchange_compressed", capture)
    batch = _torch_batch(_batch(0, tcfg))
    state, m = fn(state, batch)
    assert seen["pods"] == (torch.device("cpu"),) * 2 and seen["kw"]["compress"]
    assert int(state["step"]) == 1 and np.isfinite(float(m["loss"]))
    # the metrics are the pods' means; each pod's loss is its rows' loss
    pod_losses = []
    for k in range(2):
        one, _ = _port_state(start)
        rows = {n: v[2 * k: 2 * k + 2] for n, v in batch.items()}
        pod_losses.append(float(steps.train_step(one, rows, cfg=tcfg, traincfg=tc)[1]["loss"]))
    assert abs(float(m["loss"]) - np.mean(pod_losses)) <= 1e-6 * np.mean(pod_losses)
    n_compressed = 0
    for name, g in seen["stack"].items():
        g = g.numpy()
        if g[0].size < steps.grad_compress.MIN_COMPRESS_SIZE:
            want = g.mean(0)
        else:
            n_compressed += 1
            want = np.mean([np.asarray(jgc.decompress_leaf(jgc.compress_leaf(jax.numpy.asarray(
                g[k])), g[k].shape)) for k in range(2)], axis=0)
        assert np.abs(seen["out"][name].numpy() - want).max() <= 1e-6, name
    assert n_compressed == 11  # embed, and each layer's wq, wo and three MLP weights
    assert set(seen["out"]) == {n for n, _ in state["params"].named_parameters()}


def test_elastic_plan():
    m1 = mesh_lib.make_host_mesh(data=1, model=1, device="cpu")
    m2 = mesh_lib.make_host_mesh(data=1, model=1, pod=1, device="cpu")
    plan = elastic.plan_remesh(m2, m1)
    assert plan.microbatch_scale == 1.0
    assert "remesh" in plan.describe()
    big = mesh_lib.make_host_mesh(data=4, model=2, pod=2, device="cpu")
    plan = elastic.plan_remesh(big, mesh_lib.make_host_mesh(data=2, model=1, device="cpu"))
    assert plan.old_axes == {"pod": 2, "data": 4, "model": 2}
    assert plan.microbatch_scale == 4.0
    assert mesh_lib.make_production_mesh(multi_pod=True, device="cpu").shape == {
        "pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("axis", [None, "data", "pod"])
def test_restore_onto_mesh(tmp_path, axis):
    """A step compressed over a 4-device mesh restores onto one device: the
    manager's lz_mesh follows the new mesh, and an lz_batch_axis the new
    mesh's codec axis lacks ("pod") falls back to None."""
    cfg = configs.reduced_config(configs.get_config("llama3.2-1b"))
    tc = TrainConfig()
    state = steps.init_train_state(cfg, tc, 1, device="cpu")
    old = mesh_lib.make_host_mesh(data=2, model=1, pod=2, device="cpu")
    CheckpointManager(str(tmp_path), lz_mesh=old, device="cpu").save(state, 2)
    reader = CheckpointManager(str(tmp_path), lz_mesh=old, lz_batch_axis=axis, device="cpu")
    new = mesh_lib.make_host_mesh(data=1, model=1, device="cpu")
    restored, step = elastic.restore_onto_mesh(reader, cfg, tc, new)
    assert step == 2
    for a, b in zip(jax.tree.leaves(convert.train_state_to_numpy(state)),
                    jax.tree.leaves(convert.train_state_to_numpy(restored))):
        assert np.array_equal(a, b)


def test_shardings_are_placements():
    cfg = configs.reduced_config(configs.get_config("llama3.2-1b"))
    mesh = mesh_lib.make_host_mesh(data=2, model=1, device="cpu")
    sh = steps.train_state_shardings(cfg, TrainConfig(), mesh)
    axes = steps.model_lib.param_axes(cfg)
    assert set(sh["params"]) == set(axes) == set(sh["opt"]["m"])
    for k, a in axes.items():
        assert sh["params"][k] == rules.Placement(torch.device("cpu"), rules.spec_for(a))
        assert sh["opt"]["m"][k].spec == rules.zero_spec(
            rules.spec_for(a), tuple(dict(steps.model_lib.abstract_params(cfg).state_dict())[
                k].shape), mesh)
    assert rules.batch_spec(mesh, 4) == ("data",) and rules.batch_spec(mesh, 3) == (None,)
    pods = mesh_lib.make_host_mesh(data=2, model=1, pod=2, device="cpu")
    assert rules.batch_axes(pods) == ("pod", "data") and rules.batch_spec(pods, 8) == (
        ("pod", "data"),)
    fn, p_sh, cache_sh, b_sh = steps.make_decode_step(cfg, mesh, ShapeConfig("d", 32, 2,
                                                                             "decode"))
    assert b_sh["pos"].spec == () and b_sh["tokens"].spec == ("data",)
    assert cache_sh[0]["attn"]["k"].spec[:3] == ("data", None, "model")
    rules.set_activation_batch_axes(("data",), data_shards=1)


def test_decode_and_prefill_steps_match_the_model():
    cfg = configs.reduced_config(configs.get_config("llama3.2-1b"))
    state = steps.init_train_state(cfg, TrainConfig(), 0, device="cpu")
    mesh = mesh_lib.make_host_mesh(device="cpu")
    prefill, _, _ = steps.make_prefill_step(cfg, mesh, ShapeConfig("p", 16, 2, "prefill"))
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    logits = prefill(state["params"], {"tokens": toks})
    assert torch.equal(logits, steps.transformer.prefill(state["params"], cfg, tokens=toks))
    decode, _, _, _ = steps.make_decode_step(cfg, mesh, ShapeConfig("d", 16, 2, "decode"))
    caches = steps.model_lib.transformer.init_cache(cfg, 2, 16, device="cpu")
    tok, caches = decode(state["params"], caches, {"tokens": toks[:, 0], "pos": torch.tensor(0)})
    assert tok.dtype == torch.int32 and tok.shape == (2,)
    rules.set_activation_batch_axes(("data",), data_shards=1)


def test_train_main_resumes_on_cpu(tmp_path, capsys):
    common = ["--reduced", "--batch", "2", "--seq", "32", "--device", "cpu", "--log-every", "1",
              "--ckpt-dir", str(tmp_path / "ckpt")]
    hb = tmp_path / "hb.json"
    losses = train.main(common + ["--steps", "4", "--ckpt-every", "2", "--async-ckpt",
                                  "--heartbeat", str(hb)])
    assert len(losses) == 4 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "[train] final checkpoint:" in out and "[train] async writer:" in out
    assert json.loads(hb.read_text())["step"] == 3
    more = train.main(common + ["--steps", "6"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(more) == 2
    assert CheckpointManager(str(tmp_path / "ckpt"), device="cpu").steps() == [2, 4, 6]
    rules.set_activation_batch_axes(("data",), data_shards=1)


def test_serve_main_on_cpu(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
                "--kv-compress"])
    out = capsys.readouterr().out
    assert "generated (2, 12)" in out and "first sequence:" in out
