"""The port's AdamW (repro_torch.optim.adamw) against the reference
package's, on the CPU.

The reduced llama3.2-1b's weights and seeded gradients cross from the
reference's trees into port models (models/convert.py).  Several steps run
past the warm-up in both packages.  The tolerance: parameters (f32 and
bf16) and the f32 moments within 1e-6 relative (of max |reference| a
tensor), since the cosine, the powers of beta and the norm's summation
order may round apart in the last bit (measured: 1.4e-7 for f32
parameters, 4.5e-7 for moments, bf16 bit-equal); the global norm, a sum
of about 2 M f32 squares taken in another order, within 1e-5 (measured
1.6e-6 in bf16).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrain
from repro.optim import adamw as jadamw
from repro_torch import optim
from repro_torch.configs.base import TrainConfig
from repro_torch.models import convert

from _torch_model_ref import pair
from _torch_threads import _one_thread  # noqa: F401

TRAIN = dict(learning_rate=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1)


def _grad_tree(params, seed):
    """Seeded normal gradients shaped and typed like a reference tree."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 0.05, p.dtype), params)


def _flat(model_tree, cfg):
    """{port parameter name: f32 numpy array} of a reference params tree."""
    return {k: v.float().numpy() for k, v in convert.params_from_numpy(
        jax.tree.map(np.asarray, model_tree), cfg, device="cpu").state_dict().items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 1e9], ids=["clipped", "unclipped"])
def test_adamw_matches_reference_over_steps(dtype, grad_clip):
    jcfg, tcfg = pair("llama3.2-1b", dtype=dtype)
    from repro.models import model as jmodel

    jp = jmodel.init_params(jcfg, 0)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jopt, topt = jadamw.init_opt_state(jp), optim.init_opt_state(tp)
    assert set(topt["m"]) == {n for n, _ in tp.named_parameters()}
    assert all(m.dtype == torch.float32 for m in topt["v"].values())
    jtc, ttc = JTrain(grad_clip=grad_clip, **TRAIN), TrainConfig(grad_clip=grad_clip, **TRAIN)
    for step in range(5):  # warm-up 0, 1, then the cosine
        jg = _grad_tree(jp, seed=step)
        tg = dict(convert.params_from_numpy(jax.tree.map(np.asarray, jg), tcfg,
                                            device="cpu").named_parameters())
        jp, jopt, jmet = jadamw.adamw_update(jp, jg, jopt, jnp.int32(step), jtc)
        step_arg = torch.tensor(step, dtype=torch.int32) if step % 2 else step
        tp, topt, tmet = optim.adamw_update(tp, tg, topt, step_arg, ttc)
        assert math.isclose(float(tmet["lr"]), float(jmet["lr"]), rel_tol=1e-6)
        # a sum of about 2 M squares in f32, taken in another order
        assert math.isclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rel_tol=1e-5)
    want = _flat(jp, tcfg)
    for name, p in tp.state_dict().items():
        assert p.dtype == getattr(torch, dtype)
        got, ref = p.float().numpy(), want[name]
        assert np.abs(got - ref).max() <= 1e-6 * max(np.abs(ref).max(), 1e-30), name
    for part in ("m", "v"):
        ref = _flat_f32(jopt[part])
        for name, got in topt[part].items():
            r = ref[name]
            assert np.abs(got.numpy() - r).max() <= 1e-6 * max(np.abs(r).max(), 1e-30), name


def _flat_f32(tree):
    """{port parameter name: f32 numpy} of a reference f32 state tree."""
    out = {}
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(tree, "")
    for k, v in flat.items():
        if k.startswith("layers."):
            for i in range(v.shape[0]):
                out[f"layers.{i}.{k[len('layers.'):]}"] = v[i]
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_lr_schedule_matches_reference(step):
    jtc = JTrain(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    ttc = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    want = float(jadamw.lr_schedule(jnp.int32(step), jtc))
    for arg in (step, torch.tensor(step)):
        got = optim.lr_schedule(arg, ttc)
        assert got.dtype == torch.float32 and math.isclose(float(got), want, rel_tol=1e-6)


def test_lr_schedule_shape():
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(optim.lr_schedule(s, tc)) for s in range(100)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) < 1e-9
    assert lrs[99] < lrs[50] < lrs[11]
    assert lrs[99] >= 0.1 * 1e-3 - 1e-9


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 4.0])}  # norm 5
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.8], rtol=1e-6)
    unclipped, _ = optim.clip_by_global_norm(g, 10.0)
    np.testing.assert_allclose(unclipped["a"].numpy(), [3.0, 4.0])
    mixed = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0], dtype=torch.bfloat16)}
    assert float(optim.global_norm(mixed)) == float(jadamw.global_norm(
        {"a": jnp.array([3.0]), "b": jnp.array([4.0], jnp.bfloat16)}))


class _One(torch.nn.Module):
    def __init__(self, values, dtype):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(values, dtype=dtype))


def test_adamw_matches_hand_rolled_reference():
    """The numpy AdamW of tests/test_optim.py (bias-corrected, step t=1)."""
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.1,
                     grad_clip=1e9)
    p = _One([1.0, -2.0, 3.0], torch.float32)
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    new_p, _, _ = optim.adamw_update(p, g, optim.init_opt_state(p), 0, tc)
    lr = 1e-2 * (0.1 + 0.45 * (1 + np.cos(0.0)))
    m = 0.1 * np.array([0.1, 0.2, -0.3])
    v = 0.05 * np.array([0.1, 0.2, -0.3]) ** 2
    want = np.array([1.0, -2.0, 3.0]) - lr * (
        m / (1 - 0.9) / (np.sqrt(v / (1 - 0.95)) + 1e-8) + 0.1 * np.array([1.0, -2.0, 3.0]))
    assert new_p is p
    np.testing.assert_allclose(p.w.detach().numpy(), want, rtol=1e-5)


def test_bf16_params_fp32_moments():
    tc = TrainConfig(grad_clip=1e9)
    p = _One([1.0] * 4, torch.bfloat16)
    opt = optim.init_opt_state(p)
    assert opt["m"]["w"].dtype == torch.float32
    _, new_opt, _ = optim.adamw_update(p, {"w": torch.full((4,), 0.01, dtype=torch.bfloat16)},
                                       opt, 0, tc)
    assert p.w.dtype == torch.bfloat16
    assert new_opt["v"]["w"].dtype == torch.float32


def test_optim_exports_match_reference():
    import repro.optim as jopt

    assert optim.__all__ == jopt.__all__
    assert dataclasses.is_dataclass(TrainConfig)
