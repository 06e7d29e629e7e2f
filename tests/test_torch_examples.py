"""The port's examples (repro_torch.examples) against the reference's, on the CPU.

Each example runs with ``--device cpu`` and keeps its own asserts.  The
reference's examples take half a minute or more each here, so the numbers
they print are recomputed from the reference's own parts on the same
inputs instead of running them whole:

* quickstart: the reference's ``lzss.compress`` at each (S, W) and its
  default config, ``select_params`` and ``compress_chunks``, on the codes
  the port compressed.  With the reference's quantization codes the port
  prints the reference's lines; its own codes differ from them where the
  port's quantize divides by 2·eb and XLA's CPU multiplies by its f32
  reciprocal, which rounds a few pre-quantized values to the other integer
  (ROADMAP.md §3), and on those codes too the port prints what the
  reference's parts give.
* compress_checkpoint: from the reference's initial state the port's
  checkpoint stores the bytes the reference's ``CheckpointManager`` stores
  for that state, and restores bit for bit.
* serve_batched: paged tokens equal dense, the tier evicts and restores.
* train_tiny_lm (``--tiny``): from the reference's initial state, in f32,
  the first 3 losses within 1e-5 of the reference's ``train_step`` at the
  arguments ``train_loop`` gives it (the reference's ``train_loop`` itself
  does not run on this jax: its meshed step raises a ShardingTypeError).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs.base import TrainConfig as JTrain
from repro.core import lzss as jlzss
from repro.core import quant as jquant
from repro.core.params import select_params as jselect_params
from repro.data.pipeline import DataConfig, make_batch_for_step
from repro.launch import steps as jsteps
from repro_torch.core import quant
from repro_torch.examples import compress_checkpoint, quickstart, serve_batched, train_tiny_lm
from repro_torch.launch import steps, train
from repro_torch.models import convert

from _torch_model_ref import to_port_config

CPU = "cpu"


def _quickstart_field():
    t = np.linspace(0, 60 * np.pi, 1 << 19).astype(np.float32)
    return np.sin(t) * 50 + np.cos(3 * t) * 4


@functools.lru_cache(maxsize=None)
def _reference_codes() -> np.ndarray:
    field = _quickstart_field()
    eb = jquant.relative_error_bound(field, 1e-3)
    return np.asarray(jquant.quantize(jnp.asarray(field), error_bound=eb, ndim=1).codes)


@functools.lru_cache(maxsize=None)
def _reference_noisy_line() -> str:
    rng = np.random.default_rng(0)  # the example's first draw
    noisy = rng.integers(0, 2**31, 1 << 16).astype(np.int32)
    picked = jselect_params(noisy, level=3)
    return (f"selector on incompressible int32: S={picked.symbol_size} "
            f"(falls back to byte matching)")


def _reference_quickstart(codes: np.ndarray) -> list:
    """The lines quickstart prints for these uint16 codes, from the
    reference's parts (the example's calls, on the CPU's xla backend)."""
    lines = []
    for s in (1, 2):
        for w in (32, 128):
            res = jlzss.compress(codes, jlzss.LZSSConfig(symbol_size=s, window=w,
                                                         chunk_symbols=2048, backend="xla"))
            lines.append(f"S={s} W={w:3d}: ratio {res.ratio:5.2f} "
                         f"({res.orig_bytes} -> {res.total_bytes} bytes)")
    cfg = jlzss.DEFAULT_CONFIG
    lines.append(f"roundtrip OK at default config, ratio {jlzss.compress(codes, cfg).ratio:.2f}")
    picked = jselect_params(codes, level=3)
    lines.append(f"selector picked: S={picked.symbol_size} W={picked.window}")
    lines.append(_reference_noisy_line())
    symbols = jlzss.pack_symbols(jnp.asarray(codes.view(np.uint8)), 2)
    _, total = jlzss.compress_chunks(symbols.reshape(-1, cfg.chunk_symbols), cfg)
    lines.append(f"on-device compress_chunks: {symbols.size * 2} -> {int(total)} bytes "
                 "(stays on cpu, used for gradient/KV compression)")
    return lines


def test_quickstart_prints_the_reference_numbers(monkeypatch, capsys):
    real = quant.quantize

    def reference_codes(x, *, error_bound, ndim=1):
        q = real(x, error_bound=error_bound, ndim=ndim)
        codes = torch.from_numpy(_reference_codes().astype(np.int32)).to(x.device)
        return dataclasses.replace(q, codes=codes)

    monkeypatch.setattr(quant, "quantize", reference_codes)
    quickstart.main(["--device", CPU])
    lines = capsys.readouterr().out.splitlines()
    assert lines == _reference_quickstart(_reference_codes().astype(np.uint16))


def test_quickstart_own_codes_differ_at_the_reciprocal_roundings(capsys):
    field = _quickstart_field()
    eb = quant.relative_error_bound(field, 1e-3)
    ours = quant.quantize(torch.from_numpy(field), error_bound=eb).codes.numpy()
    ref = _reference_codes()
    # the pre-quantized values that the f32 reciprocal's product rounds to
    # the other integer; each flips its code and the next one
    div = np.float32(2 * eb)
    flips = np.nonzero(np.round(field / div) != np.round(field * (np.float32(1) / div)))[0]
    assert flips.size > 0
    assert np.nonzero(ours != ref)[0].tolist() == sorted({*flips.tolist(), *(flips + 1).tolist()})
    quickstart.main(["--device", CPU])
    lines = capsys.readouterr().out.splitlines()
    assert lines == _reference_quickstart(ours.astype(np.uint16))


@functools.lru_cache(maxsize=None)
def _reference_state(dtype: str):
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config("llama3.2-1b")), dtype=dtype)
    return jcfg, jsteps.init_train_state(jcfg, JTrain(), 0)


def _from_reference(dtype):
    jcfg, jstate = _reference_state(dtype)
    return convert.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          to_port_config(jcfg), device=CPU)


def test_compress_checkpoint_stores_the_reference_bytes(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(steps, "init_train_state",
                        lambda cfg, tc, seed=0, device="cuda": _from_reference("bfloat16"))
    st = compress_checkpoint.main(["--device", CPU])
    out = capsys.readouterr().out.splitlines()
    # what the reference's example saves: its initial state, params * 1.0
    _, jstate = _reference_state("bfloat16")
    jstate = dict(jstate, params=jax.tree.map(
        lambda p: p if p.dtype == np.int32 else p * 1.0, jstate["params"]))
    mgr = JCheckpointManager(str(tmp_path), compress=True)
    mgr.save(jstate, 100)
    want = mgr.stats(100)
    assert (st["orig_bytes"], st["stored_bytes"]) == (want["orig_bytes"], want["stored_bytes"])
    assert out == [f"checkpoint: {want['orig_bytes'] / 1e6:.2f} MB -> "
                   f"{want['stored_bytes'] / 1e6:.2f} MB (ratio {want['ratio']:.2f})",
                   "restored step 100, bit-exact: True"]


def test_serve_batched_keeps_its_asserts(capsys):
    out, paged = serve_batched.main(["--device", CPU])
    assert out.tokens.shape == (4, 36)
    st = paged.kv_store.stats
    assert st.evictions > 0 and st.restores > 0
    assert paged.paging_stats()["high_water"] <= 24
    assert "paged tokens bit-identical to dense" in capsys.readouterr().out


def _reference_losses(n: int) -> list:
    """The reference's train_step, f32, with train.build's TrainConfig for
    --tiny (30 steps, warm-up 3, lr 3e-4) on make_batch_for_step."""
    jcfg, state = _reference_state("float32")
    tc = JTrain(total_steps=30, warmup_steps=3, learning_rate=3e-4, microbatches=1)
    step = jax.jit(functools.partial(jsteps.train_step, cfg=jcfg, traincfg=tc))
    dc = DataConfig(vocab_size=jcfg.vocab_size, seq_len=256, global_batch=4, seed=tc.seed)
    losses = []
    for i in range(n):
        state, metrics = step(state, make_batch_for_step(dc, i))
        losses.append(float(metrics["loss"]))
    return losses


def test_train_tiny_lm_first_losses_equal_reference(monkeypatch, tmp_path):
    real_reduced = train.configs.reduced_config
    monkeypatch.setattr(train.configs, "reduced_config",
                        lambda cfg: dataclasses.replace(real_reduced(cfg), dtype="float32"))
    monkeypatch.setattr(train.steps, "init_train_state",
                        lambda cfg, tc, seed=0, device="cuda": _from_reference("float32"))
    losses = train_tiny_lm.main(["--tiny", "--device", CPU, "--ckpt-dir", str(tmp_path / "c")])
    assert len(losses) == 30 and losses[-1] < losses[0]
    ref = _reference_losses(3)
    assert np.max(np.abs(np.asarray(losses[:3]) - ref)) <= 1e-5, (losses[:3], ref)
    assert sorted(p.name for p in (tmp_path / "c").iterdir())[-1].startswith("step_00000030")


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for example in (quickstart, compress_checkpoint, serve_batched):
        with pytest.raises(RuntimeError, match="CUDA"):
            example.main([])
