"""The port's parameter selection and data pipeline against the reference,
on the CPU.

``repro_torch.core.params`` and ``repro_torch.data.pipeline`` are held to
``repro.core.params`` and ``repro.data.pipeline`` on the same seeded numpy
inputs.  The selector decides on exact compression ratios and the batches
are integers, so the tolerance is exact equality everywhere.
"""

import numpy as np
import pytest
import torch

from repro.core import params as jparams
from repro.data import pipeline as jdata
from repro_torch import core as tcore
from repro_torch.core import params as tparams
from repro_torch.data import pipeline as tdata

from _torch_threads import _one_thread  # noqa: F401

CPU = "cpu"
C = 256  # chunk width of the selector tests: small, so the reference is quick


def _fields(kind: str, n: int = 3, size: int = 3072):
    """A seeded sequence of uint16 fields: compressible, noisy, or both."""
    rng = np.random.default_rng({"compressible": 1, "noisy": 2, "mixed": 3}[kind])
    out = []
    for i in range(n):
        if kind == "compressible" or (kind == "mixed" and i % 2):
            x = np.repeat(rng.integers(0, 7, size), rng.integers(1, 9, size))[:size]
        else:
            x = rng.integers(0, 1 << 16, size)
        out.append(x.astype(np.uint16))
    return out


def _fields_of(cfg):
    return (cfg.symbol_size, cfg.window, cfg.chunk_symbols)


@pytest.mark.parametrize("dtype", [
    np.uint8, np.int8, np.uint16, np.int16, np.float16, np.uint32, np.int32,
    np.float32, np.int64, np.float64, np.complex64, np.bool_,
])
def test_dtype_symbol_size_equals_reference(dtype):
    assert tparams.dtype_symbol_size(dtype) == jparams.dtype_symbol_size(dtype)


@pytest.mark.parametrize("kind", ["compressible", "noisy", "mixed"])
@pytest.mark.parametrize("enlarge", [True, False])
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_selector_picks_the_reference_configs(kind, enlarge, level):
    """Field by field, the same config is used and the same one comes next;
    the running mean ratio is equal to the last bit."""
    j = jparams.ParamSelector(dtype=np.uint16, level=level, chunk_symbols=C,
                              enlarge_window=enlarge)
    t = tparams.ParamSelector(dtype=np.uint16, level=level, chunk_symbols=C,
                              enlarge_window=enlarge)
    assert _fields_of(t.current_config()) == _fields_of(j.current_config())
    for field in _fields(kind):
        assert _fields_of(t.observe(field, device=CPU)) == _fields_of(j.observe(field))
        assert _fields_of(t.current_config()) == _fields_of(j.current_config())
        assert t.mean_ratio == j.mean_ratio
    assert t._ratios == j._ratios


def test_selector_falls_back_to_byte_matching_on_noise():
    t = tparams.ParamSelector(dtype=np.uint16, chunk_symbols=C)
    assert t.current_config().symbol_size == 2
    t.observe(_fields("noisy")[0], device=CPU)
    assert t.mean_ratio < tparams.RATIO_THRESHOLD
    assert t.current_config().symbol_size == 1
    assert tparams.ParamSelector(dtype=np.uint16).mean_ratio == 0.0


@pytest.mark.parametrize("kind", ["compressible", "noisy"])
def test_select_params_equals_reference(kind):
    sample = _fields(kind, n=1, size=8192)[0]
    got = tparams.select_params(sample, level=2, device=CPU)
    assert _fields_of(got) == _fields_of(jparams.select_params(sample, level=2))


def test_selector_is_exported_from_core():
    assert tcore.ParamSelector is tparams.ParamSelector
    assert tcore.select_params is tparams.select_params


def test_selector_observe_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tparams.ParamSelector(dtype=np.uint16).observe(_fields("noisy")[0])


# ------------------------------------------------------------ data pipeline


CONFIGS = [
    dict(vocab_size=1000, seq_len=512, global_batch=4, seed=0),
    dict(vocab_size=32000, seq_len=64, global_batch=3, seed=7),
    dict(vocab_size=50, seq_len=1, global_batch=2, seed=3),
]


@pytest.mark.parametrize("step", [0, 1, 17, 12345])
@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_synthetic_batches_equal_reference(ci, step):
    t = tdata.make_batch_for_step(tdata.DataConfig(**CONFIGS[ci]), step)
    j = jdata.make_batch_for_step(jdata.DataConfig(**CONFIGS[ci]), step)
    assert t.keys() == j.keys()
    assert t["tokens"].dtype == j["tokens"].dtype == np.int32
    assert np.array_equal(t["tokens"], j["tokens"])


@pytest.mark.parametrize("step", [0, 1, 2, 9])
def test_mmap_batches_equal_reference(tmp_path, step):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(5).integers(0, 1 << 30, 5000).astype(np.int32).tofile(path)
    kw = dict(vocab_size=1 << 30, seq_len=100, global_batch=6, source="mmap", path=str(path))
    t = tdata.make_batch_for_step(tdata.DataConfig(**kw), step)["tokens"]
    j = jdata.make_batch_for_step(jdata.DataConfig(**kw), step)["tokens"]
    assert t.shape == (6, 100) and np.array_equal(t, j)


def test_prefetcher_on_cpu_gives_the_reference_batches():
    cfg = dict(vocab_size=500, seq_len=128, global_batch=2, seed=11)
    t = tdata.Prefetcher(tdata.DataConfig(**cfg), start_step=5, device=CPU)
    j = jdata.Prefetcher(jdata.DataConfig(**cfg), start_step=5)
    for _ in range(4):
        got, want = t.next(), j.next()
        assert isinstance(got["tokens"], torch.Tensor)
        assert got["tokens"].dtype == torch.int32 and got["tokens"].device.type == CPU
        assert np.array_equal(got["tokens"].numpy(), want["tokens"])


def test_prefetcher_without_a_device_keeps_numpy():
    cfg = tdata.DataConfig(vocab_size=500, seq_len=32, global_batch=2)
    p = tdata.Prefetcher(cfg, start_step=0)
    got = p.next()["tokens"]
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, tdata.make_batch_for_step(cfg, 0)["tokens"])
    assert np.array_equal(p.next()["tokens"], tdata.make_batch_for_step(cfg, 1)["tokens"])
