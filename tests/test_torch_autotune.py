"""The port's chunk-geometry autotuner against the reference, on the CPU.

``repro_torch.core.autotune`` keeps the reference's surface
(``repro.core.autotune``): the same ``cache_key`` strings, the same cache
schema in both directions, the same gating, memo and recovery.  Its Hopper
rules (one g, the shared-memory budget, the CUDA-graph guard) are checked
here with stand-in measures; timings themselves mean nothing on the CPU.
Everything compared is a string, an integer pair or container bytes, so
the tolerance is exact equality.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import autotune as jtune
from repro.core import pipeline as jpipe
from repro_torch import core as tcore
from repro_torch.core import autotune as tune
from repro_torch.core import pipeline as tpipe

from _torch_threads import _one_thread  # noqa: F401

CPU = "cpu"
LADDER = [(c, tune.DEFAULT_CHUNKS_PER_BLOCK) for c in tune.CHUNK_SYMBOL_CANDIDATES]


@pytest.fixture
def tuned_env(tmp_path, monkeypatch):
    """Tuning force-enabled against an isolated cache file."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(tune.ENABLE_ENV, "1")
    monkeypatch.setenv(tune.CACHE_ENV, str(path))
    tune.reset()
    yield path
    tune.reset()


def _key(chunk_symbols=None, symbol_size=2, direction="compress", window=128):
    return tune.TuneKey(
        device_kind="cpu", dtype=tune.default_dtype(symbol_size), symbol_size=symbol_size,
        window=window if direction == "compress" else 0, direction=direction,
        chunk_symbols=chunk_symbols,
    )


def _counting(calls):
    def measure(c, g):
        calls.append((c, g))
        return 1.0 / c  # deterministic: the widest candidate wins
    return measure


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA_H100_80GB_HBM3", "TPU_v4"])
@pytest.mark.parametrize("direction", ["compress", "decompress"])
@pytest.mark.parametrize("c", [None, 64, 2048])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_cache_key_strings_equal_reference(kind, direction, c, s):
    fields = dict(device_kind=kind, dtype=tune.default_dtype(s), symbol_size=s,
                  window=0 if direction == "decompress" else 255, direction=direction,
                  chunk_symbols=c)
    assert tune.TuneKey(**fields).cache_key() == jtune.TuneKey(**fields).cache_key()
    assert tune.default_dtype(s) == jtune.default_dtype(s)


def test_constants_equal_reference():
    assert (tune.CACHE_VERSION, tune.CACHE_ENV, tune.ENABLE_ENV) == (
        jtune.CACHE_VERSION, jtune.CACHE_ENV, jtune.ENABLE_ENV)
    assert tune.CHUNK_SYMBOL_CANDIDATES == jtune.CHUNK_SYMBOL_CANDIDATES
    assert (tune.DEFAULT_CHUNK_SYMBOLS, tune.DEFAULT_CHUNKS_PER_BLOCK) == (
        jtune.DEFAULT_CHUNK_SYMBOLS, jtune.DEFAULT_CHUNKS_PER_BLOCK)
    assert tune.FALLBACK_TABLE == {}


def test_cache_written_by_the_reference_is_read_by_the_port(tmp_path):
    path = str(tmp_path / "ref.json")
    key = _key()
    entry = {"chunk_symbols": 1024, "chunks_per_block": 8, "seconds_per_call": 2e-3,
             "device_kind": "cpu", "direction": "compress", "swept": 4}
    jtune._store_cache(path, {"version": jtune.CACHE_VERSION,
                              "entries": {key.cache_key(): entry}})
    obj = json.load(open(path))
    tune.validate_cache(obj)
    assert tune._load_cache(path) == obj
    assert tune._entry_geometry(obj, key) == (1024, 8)


def test_cache_written_by_the_port_is_read_by_the_reference(tuned_env):
    key = _key()
    geom = tune.best_geometry(key, _counting([]))
    obj = json.loads(tuned_env.read_text())
    jtune.validate_cache(obj)
    assert jtune._load_cache(str(tuned_env)) == obj
    ref_key = jtune.TuneKey(**dataclasses.asdict(key))
    assert jtune._entry_geometry(obj, ref_key) == geom == (4096, 8)
    assert not list(tuned_env.parent.glob("*.tmp.*"))  # the tmp file was replaced


_ENTRY = {"chunk_symbols": 2048, "chunks_per_block": 8, "seconds_per_call": 1e-3,
          "device_kind": "cpu", "direction": "decompress", "swept": 3}
MALFORMED = [
    [],
    {"version": 999, "entries": {}},
    {"version": 1, "entries": []},
    {"version": 1, "entries": {"k": "garbage"}},
    {"version": 1, "entries": {"k": dict(_ENTRY, chunks_per_block=0)}},
    {"version": 1, "entries": {"k": dict(_ENTRY, chunk_symbols="2048")}},
    {"version": 1, "entries": {"k": dict(_ENTRY, seconds_per_call=-1)}},
    {"version": 1, "entries": {"k": dict(_ENTRY, seconds_per_call=None)}},
]


@pytest.mark.parametrize("bad", MALFORMED)
def test_malformed_caches_rejected_by_both(bad, tmp_path):
    with pytest.raises(ValueError):
        jtune.validate_cache(bad)
    with pytest.raises(ValueError):
        tune.validate_cache(bad)
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    assert tune._load_cache(str(path)) == {"version": 1, "entries": {}}


def test_valid_cache_accepted_by_both():
    good = {"version": 1, "entries": {"k": _ENTRY}}
    jtune.validate_cache(good)
    tune.validate_cache(good)


def test_corrupted_cache_recovers(tuned_env):
    """A truncated cache is treated as empty: re-swept and rewritten valid."""
    tuned_env.write_text('{"version": 1, "entries": {"k": "garbage"')
    calls = []
    geom = tune.best_geometry(_key(), _counting(calls))
    assert calls == LADDER and geom in tune.candidates(_key())
    tune.validate_cache(json.loads(tuned_env.read_text()))


def test_memo_then_cache_without_resweep(tuned_env):
    key, calls = _key(), []
    geom = tune.best_geometry(key, _counting(calls))
    assert calls == LADDER and tune._SWEEPS == {key.cache_key(): 1}
    assert tune.best_geometry(key, _counting(calls)) == geom  # memo
    assert len(calls) == len(LADDER)
    tune.reset()  # a fresh process: the file answers
    assert tune.best_geometry(key, _counting(calls)) == geom
    assert len(calls) == len(LADDER) and tune._SWEEPS == {}
    entry = json.loads(tuned_env.read_text())["entries"][key.cache_key()]
    assert (entry["chunk_symbols"], entry["chunks_per_block"], entry["swept"]) == (4096, 8, 4)


@pytest.mark.parametrize("c", [None, 64, 4096])
def test_disabled_is_the_static_geometry(monkeypatch, c):
    monkeypatch.setenv(tune.ENABLE_ENV, "0")
    tune.reset()
    assert not tune.enabled()
    want = (2048 if c is None else c, 8)
    assert tune.best_geometry(_key(c), _counting([])) == want
    assert jtune.fallback(jtune.TuneKey(**dataclasses.asdict(_key(c)))) == want
    assert tune._MEMO == {}


def test_unset_gating_follows_the_card(monkeypatch):
    monkeypatch.delenv(tune.ENABLE_ENV, raising=False)
    assert not tune.enabled()  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tune.enabled()


def test_device_kind(monkeypatch):
    assert tune.device_kind() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert tune.device_kind() == "NVIDIA_H100_80GB_HBM3"


def test_candidates_one_g_and_the_reference_ladder():
    for s in (1, 2, 4):
        assert tune.candidates(_key(symbol_size=s)) == LADDER
        assert tune.candidates(_key(64, symbol_size=s)) == [(64, 8)]
    # a C over the shared-memory budget has no candidate: the fallback
    assert not tune._fits(65536, 4)
    assert tune.candidates(_key(65536, symbol_size=4)) == [(65536, 8)]


def test_single_candidate_key_is_never_timed(tuned_env):
    def measure(c, g):
        raise AssertionError("a key with one candidate was timed")

    for direction in ("compress", "decompress"):
        key = _key(2048, direction=direction)
        assert tune.best_geometry(key, measure) == (2048, 8)
        assert key.cache_key() in tune._MEMO
    assert not tuned_env.exists() and tune._SWEEPS == {}


def test_cached_entry_over_shared_memory_is_ignored(tuned_env):
    """A schema-valid entry whose C no longer fits one thread block's shared
    memory at this S is dropped and re-swept, never handed to a kernel."""
    key = _key(symbol_size=4)
    tuned_env.write_text(json.dumps({"version": 1, "entries": {key.cache_key(): dict(
        _ENTRY, chunk_symbols=65536, direction="compress")}}))
    tune.validate_cache(json.loads(tuned_env.read_text()))
    calls = []
    geom = tune.best_geometry(key, _counting(calls))
    assert calls == LADDER and tune._fits(geom[0], 4)
    tune.reset()
    assert tune.best_geometry(key, _counting(calls)) == geom and len(calls) == len(LADDER)


def test_cached_entry_for_another_c_is_ignored(tuned_env):
    key = _key(64, direction="decompress")
    tuned_env.write_text(json.dumps({"version": 1, "entries": {key.cache_key(): _ENTRY}}))
    assert tune._entry_geometry(json.loads(tuned_env.read_text()), key) is None


def test_cached_joint_entry_is_served(tuned_env):
    key = _key()
    tuned_env.write_text(json.dumps({"version": 1, "entries": {key.cache_key(): dict(
        _ENTRY, chunk_symbols=1024, direction="compress")}}))
    assert tune.best_geometry(key, _counting([])) == (1024, 8)


@pytest.mark.parametrize("guard", ["capture", "compile"])
def test_no_sweep_under_capture_or_compile(tuned_env, monkeypatch, guard):
    """While a CUDA graph is captured (or torch.compile traces), an untuned
    key gets the fallback, unmemoised and unpersisted; afterwards an eager
    call tunes it, and the next guarded call serves that result."""
    if guard == "capture":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    else:
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    key, calls = _key(), []
    assert not tune.trace_state_clean()
    assert tune.best_geometry(key, _counting(calls)) == tune.fallback(key) == (2048, 8)
    assert calls == [] and not tuned_env.exists() and tune._MEMO == {}
    monkeypatch.undo()
    monkeypatch.setenv(tune.ENABLE_ENV, "1")
    monkeypatch.setenv(tune.CACHE_ENV, str(tuned_env))
    assert tune.trace_state_clean()
    geom = tune.best_geometry(key, _counting(calls))
    assert calls == LADDER
    tune.reset()
    if guard == "capture":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    else:
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert tune.best_geometry(key, _counting(calls)) == geom and len(calls) == len(LADDER)


def test_tuned_config_off_is_the_static_config(monkeypatch):
    monkeypatch.setenv(tune.ENABLE_ENV, "0")
    tune.reset()
    got = tpipe.tuned_config()
    assert got == tcore.LZSSConfig(chunks_per_block=tune.DEFAULT_CHUNKS_PER_BLOCK)
    assert dataclasses.replace(got, chunks_per_block=None) == tcore.LZSSConfig()
    monkeypatch.setenv(jtune.ENABLE_ENV, "0")
    jtune.reset()
    assert tpipe.config_from_jax(dataclasses.asdict(jpipe.tuned_config())) == got
    assert tpipe.tuned_config(4, 32, chunk_symbols=512) == tcore.LZSSConfig(
        symbol_size=4, window=32, chunk_symbols=512, chunks_per_block=8)
    assert tcore.tuned_config is tpipe.tuned_config


def test_tuned_config_runs_the_sweep_on_cpu(tuned_env, monkeypatch):
    """The joint sweep through the default measure (the plain versions, a
    few KiB a candidate), persisted; the chosen C is a candidate and the
    config it builds compresses to the reference's container at that C."""
    monkeypatch.setattr(tune, "SWEEP_BYTES", 16 << 10)
    cfg = tpipe.tuned_config(2, 128)
    assert (cfg.chunk_symbols, cfg.chunks_per_block) in LADDER
    assert tune._SWEEPS == {_key().cache_key(): 1}
    assert tpipe.tuned_config(2, 128) == cfg and tune._SWEEPS == {_key().cache_key(): 1}
    tune.reset()
    assert tpipe.tuned_config(2, 128) == cfg and tune._SWEEPS == {}
    data = np.random.default_rng(0).integers(0, 4, 5000).astype(np.uint16)
    from repro.core import lzss as jlzss

    want = jlzss.compress(data, jpipe.LZSSConfig(chunk_symbols=cfg.chunk_symbols)).data
    assert np.array_equal(tcore.compress(data, cfg, device=CPU).data, want)


@pytest.mark.parametrize("direction", ["compress", "decompress"])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_default_measure_runs_on_cpu(direction, s):
    measure = tune._default_measure(_key(symbol_size=s, direction=direction), nbytes=8192)
    for c in (512, 1024):
        t = measure(c, 8)
        assert isinstance(t, float) and 0 < t < 60


@pytest.mark.parametrize("s", [1, 2, 4])
def test_sweep_inputs_are_what_the_pair_reads(s):
    """The sweep's inputs on the CPU: the compressor's container decodes
    back to the run-heavy symbols, and the all-literal container decodes
    to its payload bytes, at every C."""
    from repro_torch.kernels import ops

    enc = tune.sweep_inputs(_key(symbol_size=s), nbytes=8192)
    lit = tune.sweep_inputs(_key(symbol_size=s, direction="decompress"), nbytes=8192)
    for c in (512, 1024):
        (sym,), kw = enc(c)
        assert sym.shape == (1, 8192 // s // c, c) and kw["window"] == 128
        blobs, nt, ps, _ = ops.lz_fused_mono(sym, **kw)
        got = ops.lz_decode_mono(blobs, nt, ps, symbol_size=s, chunk_symbols=c)
        assert torch.equal(got, sym)
        (blob, nt, ps), kw = lit(c)
        got = ops.lz_decode_mono(blob, nt, ps, **kw)
        payload = blob[0, -got.numel() * s:].reshape(-1, s).to(torch.int32)
        want = sum(payload[:, k] << (8 * k) for k in range(s)).reshape(got.shape)
        assert torch.equal(got, want)


def _host_entry(entry, inputs, cfg, **pin):
    """The bytes out of one host entry point on the CPU, through the card's
    one-launch pair: the containers of a write, the decoded bytes of a
    read (``inputs`` are then containers)."""
    if entry == "compress":
        return [tcore.compress(inputs[0], cfg, device=CPU).data]
    if entry == "compress_many":
        return [tcore.compress_many(inputs, cfg, device=CPU).data]
    if entry == "decompress":
        return [tcore.decompress(inputs[0], decoder="fused-mono", device=CPU, **pin)]
    return tcore.decompress_many(inputs, decoder="fused-mono", device=CPU, **pin)


@pytest.mark.parametrize("entry", ["compress", "compress_many", "decompress", "decompress_many"])
def test_host_entry_points_never_consult_the_tuner(entry, tuned_env, monkeypatch):
    """With tuning on, a host call at a committed C leaves the memo, the
    sweep count and the cache file empty, and gives the bytes of the same
    call with tuning off.  A read's ``chunks_per_block`` pin is accepted
    and changes no byte: no Hopper kernel reads it."""
    rng = np.random.default_rng(3)
    fields = [rng.integers(0, 5, n).astype(np.uint16) for n in (3000, 1000)]
    cfg = tcore.LZSSConfig(window=33, chunk_symbols=64, backend="fused-mono")
    read = entry.startswith("decompress")
    inputs = fields
    if read:
        monkeypatch.setenv(tune.ENABLE_ENV, "0")
        batch = tcore.compress_many(fields, cfg, device=CPU)
        inputs = [batch[b].data for b in range(len(batch))]
        monkeypatch.setenv(tune.ENABLE_ENV, "1")
    tune.reset()
    got = _host_entry(entry, inputs, cfg)
    if read:
        assert all(np.array_equal(g, f.view(np.uint8)) for g, f in zip(got, fields))
        pinned = _host_entry(entry, inputs, cfg, chunks_per_block=16)
        assert len(pinned) == len(got)
        assert all(np.array_equal(a, b) for a, b in zip(pinned, got))
    assert tune._MEMO == {} and tune._SWEEPS == {} and not tuned_env.exists()
    monkeypatch.setenv(tune.ENABLE_ENV, "0")
    tune.reset()
    off = _host_entry(entry, inputs, cfg)
    assert len(off) == len(got) and all(np.array_equal(a, b) for a, b in zip(off, got))
