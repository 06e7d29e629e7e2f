"""The port's model layers against the reference's, module by module in
f32: the same inputs (numpy, from a seed) and the same weights (the
reference's init carried across).  Tolerance: max |port - reference| <=
1e-5 x max |reference|; routing metadata, int8 KV codes and cache slots
are equal exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_ref import flatten, pair, port_module, rel_err
from repro.models import attention as jattn, common as jcommon, mlp as jmlp, ssm as jssm
from repro.sharding import rules as jrules
from repro_torch.models import attention as tattn, common as tcommon, mlp as tmlp, ssm as tssm
from repro_torch.sharding import rules as trules

from _torch_threads import _one_thread  # noqa: F401

TOL = 1e-5


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, ref, tol=TOL):
    assert rel_err(got, ref) <= tol, rel_err(got, ref)


# ------------------------------------------------------------ norms, rope


def test_norms():
    x = _x((2, 5, 3, 16), 0, 3.0)
    scale = _x((16,), 1)
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    _close(tcommon.qk_head_norm(torch.from_numpy(x), 1e-6),
           jcommon.qk_head_norm(jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(theta):
    _close(tcommon.rope_frequencies(16, theta), jcommon.rope_frequencies(16, theta))
    x = _x((2, 40, 4, 16), 2)
    pos = np.arange(40, dtype=np.int32)
    _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    posv = np.full((2, 1), 37, np.int32)  # the decode form: (B, 1) positions
    _close(tcommon.apply_rope(torch.from_numpy(x[:, :1]), torch.from_numpy(posv), theta),
           jcommon.apply_rope(jnp.asarray(x[:, :1]), jnp.asarray(posv), theta))


def test_dense_init_draws_from_its_generator():
    g = torch.Generator().manual_seed(5)
    a = tcommon.dense_init(g, (64, 32), torch.float32, in_axis_size=16, scale=2.0)
    b = tcommon.dense_init(torch.Generator().manual_seed(5), (64, 32), torch.float32,
                           in_axis_size=16, scale=2.0)
    assert torch.equal(a, b) and abs(float(a.std()) - 0.5) < 0.05
    assert tcommon.dense_init(g, (8, 4), torch.bfloat16).dtype == torch.bfloat16
    meta = tcommon.dense_init(None, (1 << 20, 1 << 20), torch.float32, device="meta")
    assert meta.device.type == "meta" and meta.shape == (1 << 20, 1 << 20)


# ------------------------------------------------------------ SwiGLU, MoE


def test_swiglu():
    jcfg, tcfg = pair("llama3-8b")
    p, _ = jmlp.init_swiglu(jax.random.PRNGKey(0), jcfg)
    x = _x((2, 7, jcfg.d_model), 3)
    _close(tmlp.swiglu(port_module(tmlp.SwiGLU, tcfg, p), torch.from_numpy(x)),
           jmlp.swiglu(p, jnp.asarray(x)))


def _moe_pair(name="deepseek-v2-236b", **kw):
    jcfg, tcfg = pair(name, **kw)
    p, _ = jmlp.init_moe(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, p, port_module(tmlp.MoE, tcfg, p)


@pytest.mark.parametrize("cap", [8, 16, 64])
def test_moe_dispatch_and_combine(cap):
    jcfg, tcfg, p, mod = _moe_pair()
    xf = _x((48, jcfg.d_model), 4)
    jbuf, jmeta, jaux = jmlp._dispatch_one(jnp.asarray(xf), p, jcfg, cap)
    tbuf, tmeta, taux = tmlp._dispatch_one(torch.from_numpy(xf), mod, tcfg, cap)
    for name, g, r in zip(("slot_expert", "pos_c", "keep", "slot_token"), tmeta[:4], jmeta[:4]):
        assert np.array_equal(g.numpy(), np.asarray(r)), name
    if cap == 8:
        assert not bool(np.all(np.asarray(jmeta[2])))  # some slots dropped at the edge
    _close(tmeta[4], jmeta[4])
    _close(tbuf, jbuf)
    _close(taux, jaux)
    y = _x((jcfg.moe.num_experts, cap, jcfg.d_model), 5)
    _close(tmlp._combine_one(torch.from_numpy(y), tmeta, 48, jcfg.d_model, torch.float32),
           jmlp._combine_one(jnp.asarray(y), jmeta, 48, jcfg.d_model, jnp.float32))


def test_moe_ties_pick_the_lower_expert():
    jcfg, tcfg, p, mod = _moe_pair("llama4-scout-17b-a16e")
    p = dict(p, router=jnp.zeros_like(p["router"]))  # every probability equal
    with torch.no_grad():
        mod.router.zero_()
    xf = _x((12, jcfg.d_model), 6)
    _, jmeta, _ = jmlp._dispatch_one(jnp.asarray(xf), p, jcfg, 16)
    _, tmeta, _ = tmlp._dispatch_one(torch.from_numpy(xf), mod, tcfg, 16)
    assert np.array_equal(tmeta[0].numpy(), np.asarray(jmeta[0]))
    assert set(tmeta[0].tolist()) == set(range(jcfg.moe.top_k))


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("shards", [1, 2])
def test_moe_apply(name, shards):
    jcfg, tcfg, p, mod = _moe_pair(name)
    x = _x((2, 24, jcfg.d_model), 7)
    saved = [(m, m.activation_batch_axes(), m.data_shard_count()) for m in (jrules, trules)]
    try:
        for m in (jrules, trules):
            m.set_activation_batch_axes(("data",), shards)
        jout, jaux = jmlp.moe_apply(p, jcfg, jnp.asarray(x))
        tout, taux = tmlp.moe_apply(mod, tcfg, torch.from_numpy(x))
    finally:
        for m, axes, n in saved:
            m.set_activation_batch_axes(axes, n)
    _close(tout, jout)
    _close(taux, jaux)
    for n in (1, 7, 48, 1000):
        assert tmlp.moe_capacity(n, tcfg) == jmlp.moe_capacity(n, jcfg)


# ------------------------------------------------------------------- GQA


def _attn_pair(**updates):
    jcfg, tcfg = pair("llama3-8b", **updates)
    p, _ = jattn.init_attention(jax.random.PRNGKey(2), jcfg)
    return jcfg, tcfg, p, port_module(tattn.Attention, tcfg, p)


@pytest.mark.parametrize("is_global", [True, False])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_forward_swa_qk_norm(is_global, qk_norm):
    jcfg, tcfg, p, mod = _attn_pair(qk_norm=qk_norm, sliding_window=8)
    x = _x((2, 40, jcfg.d_model), 8)
    pos = np.arange(40, dtype=np.int32)
    jout, (jk, jv) = jattn.attention_forward(p, jcfg, jnp.asarray(x), jnp.asarray(pos), is_global)
    tout, (tk, tv) = tattn.attention_forward(mod, tcfg, torch.from_numpy(x),
                                             torch.from_numpy(pos), is_global)
    _close(tout, jout)
    _close(tk, jk)
    _close(tv, jv)


def test_attention_blocked_equals_unblocked(monkeypatch):
    """T = 1024 takes the query-blocked path (two blocks of Q_BLOCK); held to
    the unblocked path and to the reference's blocked path."""
    jcfg, tcfg, p, mod = _attn_pair(sliding_window=300)
    x = _x((1, 1024, jcfg.d_model), 9)
    pos = np.arange(1024, dtype=np.int32)
    args = (torch.from_numpy(x), torch.from_numpy(pos), False)
    blocked, _ = tattn.attention_forward(mod, tcfg, *args)
    ref, _ = jattn.attention_forward(p, jcfg, jnp.asarray(x), jnp.asarray(pos), False)
    monkeypatch.setattr(tattn, "Q_BLOCK", 4096)
    whole, _ = tattn.attention_forward(mod, tcfg, *args)
    _close(blocked, whole)
    _close(blocked, ref)


def test_kv_quant_codes_exact():
    x = _x((2, 9, 2, 16), 10, 4.0)
    x[0, 0, 0, :4] = [1.0, 0.5 / 127.0, 1.5 / 127.0, -2.5 / 127.0]  # halves: to even
    x[1, 1, 1] = 0.0  # an all-zero row takes the floor scale
    jc, js = jattn._quantize_kv(jnp.asarray(x))
    tc, ts = tattn._quantize_kv(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tattn._dequantize_kv(tc, ts, torch.float32).numpy(),
                          np.asarray(jattn._dequantize_kv(jc, js, jnp.float32)))


def _decode_run(jcfg, tcfg, p, mod, fn, steps, cache_len, is_global, seed):
    jc = jattn.init_kv_cache(jcfg, 2, cache_len, jnp.float32)
    tc = tattn.init_kv_cache(tcfg, 2, cache_len, torch.float32, device="cpu")
    for pos in range(steps):
        x = _x((2, 1, jcfg.d_model), seed + pos)
        jy, jc = getattr(jattn, fn)(p, jcfg, jc, jnp.asarray(x), jnp.int32(pos), is_global)
        ty, tc = getattr(tattn, fn)(mod, tcfg, tc, torch.from_numpy(x), pos, is_global)
        _close(ty, jy)
        assert np.array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    return jc, tc


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("is_global", [True, False])
def test_attention_decode_ring(kv_quant, is_global):
    """A 12-slot ring over 20 positions with a window of 6."""
    jcfg, tcfg, p, mod = _attn_pair(sliding_window=6, qk_norm=True, kv_quant=kv_quant)
    jc, tc = _decode_run(jcfg, tcfg, p, mod, "attention_decode", 20, 12, is_global, 100)
    for k in jc:
        if kv_quant and k in ("k", "v"):
            assert np.array_equal(tc[k].numpy(), np.asarray(jc[k])), k
        else:
            _close(tc[k], jc[k])


def test_paged_attention_decode():
    jcfg, tcfg, p, mod = _attn_pair(sliding_window=5)
    bt, nl = 4, 3
    table = np.array([[5, 0, -1], [2, 7, 3]], np.int32)
    pool = _x((8, bt, jcfg.padded_kv_heads, jcfg.hd), 11)
    jpool = {"k": jnp.asarray(pool), "v": jnp.asarray(pool * 2)}
    tpool = {"k": torch.from_numpy(pool.copy()), "v": torch.from_numpy(pool * 2)}
    for pos in range(2 * bt):  # blocks 0 and 1 are mapped in both rows
        x = _x((2, 1, jcfg.d_model), 200 + pos)
        for is_global in (True, False):
            jy, jp = jattn.paged_attention_decode(p, jcfg, jpool, jnp.asarray(table),
                                                  jnp.asarray(x), jnp.int32(pos), is_global)
            ty, tp = tattn.paged_attention_decode(mod, tcfg, tpool, torch.from_numpy(table),
                                                  torch.from_numpy(x), pos, is_global)
            _close(ty, jy)
        jpool = jp
        for k in ("k", "v"):
            _close(tp[k], jp[k])
    assert nl == table.shape[1]


# ------------------------------------------------------------------- MLA


def _mla_pair():
    jcfg, tcfg = pair("deepseek-v2-236b")
    p, _ = jattn.init_mla(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, p, port_module(tattn.MLA, tcfg, p)


@pytest.mark.parametrize("t", [24, 1024])
def test_mla_forward(t):
    jcfg, tcfg, p, mod = _mla_pair()
    x = _x((1, t, jcfg.d_model), 12)
    pos = np.arange(t, dtype=np.int32)
    jy, (jc, jr) = jattn.mla_forward(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
    ty, (tc, tr) = tattn.mla_forward(mod, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    _close(ty, jy)
    _close(tc, jc)
    _close(tr, jr)


def test_mla_decode_absorbed():
    jcfg, tcfg, p, mod = _mla_pair()
    jc = jattn.init_mla_cache(jcfg, 2, 16, jnp.float32)
    tc = tattn.init_mla_cache(tcfg, 2, 16, torch.float32, device="cpu")
    for pos in range(10):
        x = _x((2, 1, jcfg.d_model), 300 + pos)
        jy, jc = jattn.mla_decode(p, jcfg, jc, jnp.asarray(x), jnp.int32(pos))
        ty, tc = tattn.mla_decode(mod, tcfg, tc, torch.from_numpy(x), pos)
        _close(ty, jy)
    for k in jc:
        _close(tc[k], jc[k])


# ------------------------------------------------------------------- SSD


def _ssm_pair(name="mamba2-2.7b"):
    jcfg, tcfg = pair(name)
    p, _ = jssm.init_ssm(jax.random.PRNGKey(4), jcfg)
    # non-trivial dt_bias / A_log / D, so every term of the recurrence counts
    p = dict(p, dt_bias=jnp.asarray(_x(p["dt_bias"].shape, 13, 0.5)),
             A_log=jnp.asarray(_x(p["A_log"].shape, 14, 0.5)),
             D=jnp.asarray(_x(p["D"].shape, 15)))
    return jcfg, tcfg, p, port_module(tssm.SSM, tcfg, p)


def test_causal_conv_and_gated_norm():
    v, k, b = _x((2, 9, 12), 16), _x((4, 12), 17), _x((12,), 18)
    _close(tssm._causal_conv(*map(torch.from_numpy, (v, k, b))),
           jssm._causal_conv(*map(jnp.asarray, (v, k, b))))
    y, z, s = _x((2, 3, 4, 8), 19), _x((2, 3, 4, 8), 20), _x((4, 8), 21)
    _close(tssm._gated_norm(*map(torch.from_numpy, (y, z, s)), 1e-5),
           jssm._gated_norm(*map(jnp.asarray, (y, z, s)), 1e-5))


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
@pytest.mark.parametrize("t", [32, 77])
def test_ssd_forward(name, t):
    """One whole chunk (32) and a padded multi-chunk run (77 -> 3 chunks)."""
    jcfg, tcfg, p, mod = _ssm_pair(name)
    x = _x((2, t, jcfg.d_model), 22)
    jy, jst = jssm.ssm_forward(p, jcfg, jnp.asarray(x))
    ty, tst = tssm.ssm_forward(mod, tcfg, torch.from_numpy(x))
    assert ty.shape == (2, t, jcfg.d_model)
    _close(ty, jy)
    _close(tst, jst)


def test_ssd_decode():
    jcfg, tcfg, p, mod = _ssm_pair()
    jc = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    tc = tssm.init_ssm_cache(tcfg, 2, torch.float32, device="cpu")
    xs = _x((2, jcfg.ssm.chunk, jcfg.d_model), 23)  # one whole chunk: no padding
    for pos in range(jcfg.ssm.chunk):
        jy, jc = jssm.ssm_decode(p, jcfg, jc, jnp.asarray(xs[:, pos:pos + 1]))
        ty, tc = tssm.ssm_decode(mod, tcfg, tc, torch.from_numpy(xs[:, pos:pos + 1]))
        _close(ty, jy)
    for k in jc:
        _close(tc[k], jc[k])
    # the recurrence's last state is the chunked forward's final state
    _, fin = tssm.ssm_forward(mod, tcfg, torch.from_numpy(xs))
    _close(tc["state"], fin.detach().numpy())


@pytest.mark.parametrize("name,init", [
    ("hymba-1.5b", "attention.init_attention"), ("hymba-1.5b", "ssm.init_ssm"),
    ("hymba-1.5b", "mlp.init_swiglu"), ("deepseek-v2-236b", "attention.init_mla"),
    ("deepseek-v2-236b", "mlp.init_moe")])
def test_init_modules_match_the_reference(name, init):
    """Each init gives the reference's param names, shapes, dtypes and axes."""
    jcfg, tcfg = pair(name, dtype="bfloat16")
    mod_name, fn = init.split(".")
    jmod = {"attention": jattn, "ssm": jssm, "mlp": jmlp}[mod_name]
    tmod = {"attention": tattn, "ssm": tssm, "mlp": tmlp}[mod_name]
    jp, jax_axes = getattr(jmod, fn)(jax.random.PRNGKey(0), jcfg)
    mod, axes = getattr(tmod, fn)(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert axes == flatten(jax_axes)
    ref = flatten(jp)
    state = mod.state_dict()
    assert set(state) == set(ref)
    for k, v in state.items():
        assert tuple(v.shape) == ref[k].shape and str(v.dtype)[6:] == str(ref[k].dtype), k
