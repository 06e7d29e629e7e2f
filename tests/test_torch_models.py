"""The whole model, all ten reduced configs, against the reference: the
reference's weights carried across by ``params_from_numpy``, the same
tokens (numpy, from a seed).

Tolerances, relative to max |reference|: f32 logits and losses 1e-4;
bf16 logits ``BF16_TOL`` with greedy (argmax) agreement of at least 0.95
(XLA's CPU bf16 fusions keep f32 intermediates where PyTorch rounds to
bf16 after each op, about 0.01 of max |logit|; a token whose MoE routing
flips moves further: deepseek-v2's worst is 0.076); f32 gradients 1e-4 a
leaf.  Paged decode is
bit-equal to dense decode, and the three remat modes give equal values."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_ref import flatten, pair, rel_err
from repro import configs as jconfigs
from repro.models import model as jmodel, transformer as jtf
from repro_torch.models import convert, transformer as ttf

from _torch_threads import _one_thread  # noqa: F401

ARCHS = sorted(jconfigs.ARCHS)
PAGED = [n for n in ARCHS if jconfigs.get_config(n).mixer in ("attention", "hybrid")]
T = 24          # tokens of the forward, loss and decode runs
DECODE = 24     # decode positions (hymba's reduced window is 16: the ring wraps)
TOL = 1e-4
BF16_TOL = 0.1


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    batch = {"tokens": toks}
    if jmodel.uses_embedding_frontend(cfg):
        batch = {"embeds": rng.standard_normal((2, T, cfg.d_model)).astype(np.float32),
                 "labels": toks}
    return toks, batch


class Ref:
    """One arch's reference results, computed once."""

    def __init__(self, name):
        self.jcfg, self.tcfg = pair(name, no_drop=True)
        cfg = self.jcfg
        self.params = _np_tree(jmodel.init_params(cfg, 0))
        self.tokens, self.batch = _batch(cfg)
        jp = jax.tree.map(jnp.asarray, self.params)
        h, _ = jtf.forward(jp, cfg, tokens=jnp.asarray(self.tokens), remat="none")
        self.logits = np.asarray(jtf.unembed(jp, cfg, h))
        self.prefill = np.asarray(jtf.prefill(jp, cfg, tokens=jnp.asarray(self.tokens)))
        jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        total, parts = jtf.loss_fn(jp, cfg, jbatch, remat="none")
        self.loss = {k: float(v) for k, v in parts.items()}
        step = jax.jit(lambda c, tk, p: jtf.decode_step(jp, cfg, c, tk, p))
        caches, outs = jtf.init_cache(cfg, 2, DECODE), []
        for pos in range(DECODE):
            lg, caches = step(caches, jnp.asarray(self.tokens[:, pos]), jnp.int32(pos))
            outs.append(np.asarray(lg))
        self.decode = np.stack(outs, 1)
        self.caches = _np_tree(caches)
        # bf16: the reduced config as published (bf16, default capacity)
        self.jcfg16, self.tcfg16 = pair(name, dtype="bfloat16")
        p16 = jmodel.init_params(self.jcfg16, 0)
        h16, _ = jtf.forward(p16, self.jcfg16, tokens=jnp.asarray(self.tokens), remat="none")
        self.params16 = _np_tree(p16)
        self.logits16 = np.asarray(jtf.unembed(p16, self.jcfg16, h16))

    def port(self, bf16=False):
        if bf16:
            return convert.params_from_numpy(self.params16, self.tcfg16, device="cpu")
        return convert.params_from_numpy(self.params, self.tcfg, device="cpu")


@pytest.fixture(scope="module")
def ref():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = Ref(name)
        return cache[name]

    return get


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_prefill_f32(ref, name):
    r = ref(name)
    m = r.port()
    with torch.no_grad():
        h, aux = ttf.forward(m, r.tcfg, tokens=_t(r.tokens), remat="none")
        logits = ttf.unembed(m, r.tcfg, h)
    assert logits.dtype == torch.float32 and logits.shape == r.logits.shape
    assert rel_err(logits, r.logits) <= TOL
    pre = ttf.prefill(m, r.tcfg, tokens=_t(r.tokens))
    assert rel_err(pre, r.prefill) <= TOL


@pytest.mark.parametrize("name", ARCHS)
def test_forward_bf16(ref, name):
    r = ref(name)
    m = r.port(bf16=True)
    with torch.no_grad():
        h, _ = ttf.forward(m, r.tcfg16, tokens=_t(r.tokens), remat="none")
        logits = ttf.unembed(m, r.tcfg16, h)
    assert h.dtype == torch.bfloat16
    assert rel_err(logits, r.logits16) <= BF16_TOL
    agree = float(np.mean(logits.argmax(-1).numpy() == r.logits16.argmax(-1)))
    assert agree >= 0.95, agree


@pytest.mark.parametrize("name", ARCHS)
def test_loss_fn(ref, name):
    r = ref(name)
    m = r.port()
    with torch.no_grad():
        total, parts = ttf.loss_fn(m, r.tcfg, {k: _t(v) for k, v in r.batch.items()},
                                   remat="none")
    assert float(total) == float(parts["loss"])
    for k, want in r.loss.items():
        assert abs(float(parts[k]) - want) <= TOL * max(abs(want), 1e-3), (k, float(parts[k]), want)
    if r.jcfg.moe is not None:
        assert float(parts["aux"]) > 0


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step(ref, name):
    """decode_step over DECODE positions against the reference's sequence,
    and against the port's own forward."""
    r = ref(name)
    m = r.port()
    caches, outs = ttf.init_cache(r.tcfg, 2, DECODE, device="cpu"), []
    for pos in range(DECODE):
        lg, caches = ttf.decode_step(m, r.tcfg, caches, _t(r.tokens[:, pos]), pos)
        outs.append(lg)
    dec = torch.stack(outs, 1)
    assert rel_err(dec, r.decode) <= TOL
    for got, want in zip(caches, r.caches):
        g, w = flatten(got), flatten(want)
        assert set(g) == set(w)
        for k in w:
            if k.endswith("slot_pos"):
                assert np.array_equal(g[k].numpy(), w[k]), k
            else:
                assert rel_err(g[k], w[k]) <= TOL, k
    with torch.no_grad():
        h, _ = ttf.forward(m, r.tcfg, tokens=_t(r.tokens[:, :DECODE]), remat="none")
        full = ttf.unembed(m, r.tcfg, h)
    assert rel_err(dec, full) <= TOL


def _paged_run(m, cfg, tokens, paged, steps):
    outs = []
    for pos in range(steps):
        lg, paged = ttf.decode_step_paged(m, cfg, paged, _t(tokens[:, pos]), pos)
        outs.append(lg)
    return torch.stack(outs, 1)


@pytest.mark.parametrize("name", PAGED)
def test_paged_decode_bit_equal_to_dense(ref, name):
    """map_all paged decode == dense decode, bit for bit (bf16); the tokens
    run 8 prompt positions then 8 greedy ones, as a server would."""
    r = ref(name)
    m, cfg = r.port(bf16=True), r.tcfg16
    seq = 16  # within hymba's reduced window: both caches hold every position
    caches = ttf.init_cache(cfg, 2, seq, device="cpu")
    paged = ttf.init_paged_cache(cfg, 2, seq, block_tokens=4, device="cpu")
    td = tp = _t(r.tokens[:, 0])
    for pos in range(seq):
        ld, caches = ttf.decode_step(m, cfg, caches, td, pos)
        lp, paged = ttf.decode_step_paged(m, cfg, paged, tp, pos)
        assert torch.equal(ld, lp), pos
        if pos + 1 < 8:
            td = tp = _t(r.tokens[:, pos + 1])
        else:
            td, tp = ld.argmax(-1), lp.argmax(-1)
        assert torch.equal(td, tp)


@pytest.mark.parametrize("name", PAGED)
def test_paged_decode_ignores_unmapped_garbage(ref, name):
    """Garbage in pool slots no table maps, and in the slots of unmapped
    table entries, changes no bit of the logits."""
    r = ref(name)
    m, cfg = r.port(bf16=True), r.tcfg16
    total = cfg.num_layers * 2 * 4  # layers x sequences x logical blocks of 4 tokens
    runs = []
    for garbage in (False, True):
        paged = ttf.init_paged_cache(cfg, 2, 16, block_tokens=4, pool_blocks=total + 8,
                                     device="cpu")
        unmapped = paged["tables"][:, :, 2:].flatten().long()  # positions 8-15
        paged["tables"][:, :, 2:] = -1
        if garbage:
            g = torch.Generator().manual_seed(3)
            for k in ("k", "v"):
                pool = paged["pool"][k]
                for ids in (unmapped, torch.arange(total, total + 8)):
                    pool[ids] = (torch.randn(pool[ids].shape, generator=g) * 100).to(pool.dtype)
        runs.append(_paged_run(m, cfg, r.tokens, paged, 8))
    assert torch.equal(runs[0], runs[1])


def test_paged_cache_validation():
    _, cfg = pair("llama3.2-1b", dtype="bfloat16")
    with pytest.raises(ValueError):
        ttf.init_paged_cache(cfg, 2, 30, block_tokens=8, device="cpu")
    with pytest.raises(ValueError):
        ttf.init_paged_cache(cfg, 2, 32, block_tokens=8, pool_blocks=3, device="cpu")
    with pytest.raises(NotImplementedError):
        ttf.init_paged_cache(dataclasses.replace(cfg, mixer="mla"), 2, 32, block_tokens=8,
                             device="cpu")
    with pytest.raises(NotImplementedError):
        ttf.init_paged_cache(dataclasses.replace(cfg, kv_quant=True), 2, 32, block_tokens=8,
                             device="cpu")
    unmapped = ttf.init_paged_cache(cfg, 2, 32, block_tokens=8, map_all=False, device="cpu")
    assert bool((unmapped["tables"] == -1).all())


@pytest.mark.parametrize("name", ["llama3-8b", "deepseek-v2-236b"])
def test_gradients_f32(ref, name):
    """autograd of loss_fn against jax.grad, leaf by leaf."""
    r = ref(name)
    jp = jax.tree.map(jnp.asarray, r.params)
    jbatch = {k: jnp.asarray(v) for k, v in r.batch.items()}
    jgrad = jax.grad(lambda p: jtf.loss_fn(p, r.jcfg, jbatch, remat="none")[0])(jp)
    m = r.port()
    total, _ = ttf.loss_fn(m, r.tcfg, {k: _t(v) for k, v in r.batch.items()}, remat="full")
    total.backward()
    grads = convert.params_to_numpy(_grads_as_model(m))
    want, got = flatten(_np_tree(jgrad)), flatten(grads)
    assert set(want) == set(got)
    for k in want:
        assert rel_err(got[k], want[k]) <= TOL, (k, rel_err(got[k], want[k]))


def _grads_as_model(m):
    """A copy of ``m`` holding its gradients as values."""
    g = convert.params_from_numpy(convert.params_to_numpy(m), m.cfg, device="cpu")
    with torch.no_grad():
        for (_, dst), (_, src) in zip(g.named_parameters(), m.named_parameters()):
            dst.copy_(src.grad)
    return g


@pytest.mark.parametrize("name", ["llama3-8b", "deepseek-v2-236b", "hymba-1.5b"])
def test_remat_modes_agree(ref, name):
    r = ref(name)
    batch = {k: _t(v) for k, v in r.batch.items()}
    out = {}
    for remat in ("full", "dots", "none"):
        m = r.port()
        total, _ = ttf.loss_fn(m, r.tcfg, batch, remat=remat)
        total.backward()
        out[remat] = (float(total.detach()), [p.grad.clone() for p in m.parameters()])
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b), remat
    with pytest.raises(ValueError):
        ttf.forward(r.port(), r.tcfg, tokens=batch.get("labels", batch.get("tokens")),
                    remat="some")


@pytest.mark.parametrize("name", ["llama3.2-1b", "deepseek-v2-236b", "mamba2-2.7b"])
def test_converter_round_trip(ref, name):
    r = ref(name)
    for tree, bf16 in ((r.params, False), (r.params16, True)):
        m = r.port(bf16=bf16)
        back = flatten(convert.params_to_numpy(m))
        want = flatten(tree)
        assert set(back) == set(want)
        for k, a in want.items():
            if a.dtype.name == "bfloat16":
                assert back[k].dtype == np.uint16 and np.array_equal(back[k], a.view(np.uint16))
            else:
                assert back[k].dtype == a.dtype and np.array_equal(back[k], a), k
        again = convert.params_from_numpy(convert.params_to_numpy(m), m.cfg, device="cpu")
        sd, sd2 = m.state_dict(), again.state_dict()
        assert all(torch.equal(sd[k], sd2[k]) and sd[k].dtype == sd2[k].dtype for k in sd)
    bad = dict(r.params, ln_f=r.params["ln_f"].astype(np.float16))
    with pytest.raises(TypeError):
        convert.params_from_numpy(bad, r.tcfg, device="cpu")
    with pytest.raises(KeyError):
        convert.params_from_numpy({k: v for k, v in r.params.items() if k != "ln_f"}, r.tcfg,
                                  device="cpu")
