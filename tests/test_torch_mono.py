"""The port's one-launch pair and match-only kernel against the reference.

On the CPU the wrappers run their kernels' plain versions; here they are
held to the reference package on the same seeded numpy inputs:

  * ``lz_fused_mono_plain`` (the one-launch compressor) to the containers
    of the reference's ``xla`` backend.  The reference's own one-launch
    compressor (``kernels/lz_fused.py``) does not run on the installed jax
    (``pl.load`` was removed), and the reference pins every method-0
    backend, that kernel included, to the ``xla`` backend's bytes, so
    ``xla`` is the reference here;
  * ``lz_decode_mono_plain`` (the one-launch decoder) to the interpret-mode
    Pallas ``lz_decode_mono_pallas`` on every lane, and to the ``xla-parallel``
    decoder;
  * ``lz_match_plain`` to the interpret-mode Pallas ``lz_match_pallas``.

Everything is integer: the tolerance is exact equality.  The CUDA kernels
are held to these plain versions on the card by tests/test_torch_gpu.py.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import format as jfmt
from repro.core import lzss as jlzss
from repro.core import pipeline as jpipe
from repro.kernels import lz_decode_mono as jlz_decode_mono
from repro.kernels import lz_match as jlz_match
from repro_torch import core as tcore
from repro_torch.core import format as tfmt
from repro_torch.core import pipeline as tpipe
from repro_torch.kernels import lz_decode_mono, lz_fused, lz_match, ops

from _torch_threads import _one_thread  # noqa: F401

CPU = "cpu"
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
GOLDEN_RAW = sorted(
    p.name[: -len(".input.bin")]
    for p in GOLDEN.glob("*.input.bin")
    if re.fullmatch(r"[a-z0-9]+_s\d_w\d+_c\d+", p.name[: -len(".input.bin")])
)


def _bytes(rng, kind, n):
    """Seeded inputs: byte runs with repeats, or runs ending in noise (the
    last tokens of the last chunk are literals)."""
    raw = np.repeat(rng.integers(0, 6, n), rng.integers(1, 9, n)).astype(np.uint8)[:n]
    base = rng.integers(0, 256, 29).astype(np.uint8)
    raw[n // 3 : n // 3 + 3 * 29] = np.tile(base, 3)[: len(raw[n // 3 : n // 3 + 3 * 29])]
    if kind == "noisy-tail":
        raw[-max(n // 6, 64) :] = rng.integers(0, 256, max(n // 6, 64))
    return raw


def _symbols(s, nc, c, seed, kind="runs"):
    raw = _bytes(np.random.default_rng(seed), kind, nc * c * s)
    return tpipe.pack_symbols(torch.from_numpy(raw), s).reshape(nc, c)


def _cfg(s, w, c, **kw):
    return dict(symbol_size=s, window=w, chunk_symbols=c, **kw)


# ------------------------------------------------- one-launch compressor


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("w", [32, 255])
@pytest.mark.parametrize("kind", ["runs", "noisy-tail"])
def test_mono_plain_equals_reference_xla(s, w, kind):
    """The plain one-launch compressor's sections, tables and totals are the
    reference ``xla`` container's, with zeros everywhere else; through the
    host API its containers are the reference's byte for byte."""
    c, nc = 128, 3
    sym = _symbols(s, nc, c, seed=s * w, kind=kind)
    mm = tpipe.LZSSConfig(symbol_size=s).min_match
    cap = tfmt.max_compressed_bytes(nc * c * s, s, c)
    sec = tfmt.HEADER_BYTES + 8 * nc
    blobs, nt, ps, totals = lz_fused.lz_fused_mono_plain(
        sym[None], window=w, min_match=mm, symbol_size=s, cap=cap, sec_flags=sec)
    jbuf, jtotal = jpipe.compress_chunks(jnp.asarray(sym.numpy()),
                                         jpipe.LZSSConfig(**_cfg(s, w, c, backend="xla")))
    want = np.asarray(jbuf)[: int(jtotal)].astype(np.uint8)
    _, jnt, jps = jfmt.validate_container(want)
    assert np.array_equal(nt[0].numpy(), jnt) and np.array_equal(ps[0].numpy(), jps)
    f_tot, p_tot = totals[0].tolist()
    assert sec + f_tot + p_tot == int(jtotal)
    got = blobs[0].numpy()
    assert np.array_equal(got[sec : int(jtotal)], want[sec:])
    assert not got[:sec].any() and not got[int(jtotal) :].any()

    raw = _bytes(np.random.default_rng(s + w), kind, 5 * c * s + 37)
    jblob = jlzss.compress(raw, jlzss.LZSSConfig(**_cfg(s, w, c, backend="xla")))
    tblob = tcore.compress(raw, tcore.LZSSConfig(**_cfg(s, w, c, backend="fused-mono")),
                           device=CPU)
    assert tblob.total_bytes == jblob.total_bytes and np.array_equal(tblob.data, jblob.data)


def test_mono_plain_ragged_batch_equals_reference():
    """A ragged batch of three buffers: one container each, in one call."""
    rng = np.random.default_rng(11)
    arrays = [_bytes(rng, "noisy-tail", n) for n in (1000, 300, 777)]
    cfg = _cfg(2, 64, 128)
    want = jlzss.compress_many(arrays, jlzss.LZSSConfig(backend="xla", **cfg))
    got = tcore.compress_many(arrays, tcore.LZSSConfig(backend="fused-mono", **cfg), device=CPU)
    assert np.array_equal(got.data, want.data)
    assert np.array_equal(got.total_bytes, want.total_bytes)
    outs = tcore.decompress_many(got, decoder="fused-mono", device=CPU)
    assert all(np.array_equal(o, a) for o, a in zip(outs, arrays))


def test_mono_plain_at_c2048():
    raw = _bytes(np.random.default_rng(5), "noisy-tail", 3 * 2048 * 2 - 11)
    cfg = _cfg(2, 128, 2048)
    jblob = jlzss.compress(raw, jlzss.LZSSConfig(backend="xla", **cfg)).data
    tblob = tcore.compress(raw, tcore.LZSSConfig(backend="fused-mono", **cfg), device=CPU).data
    assert np.array_equal(tblob, jblob)
    assert np.array_equal(tcore.decompress(tblob, decoder="fused-mono", device=CPU), raw)


# ---------------------------------------------------- one-launch decoder


def _container(s, w, c, nc, seed, kind="noisy-tail"):
    sym = _symbols(s, nc, c, seed, kind)
    blob, total = tpipe.compress_chunks(sym, tpipe.LZSSConfig(**_cfg(s, w, c)))
    blob = blob[:total].numpy()  # the live bytes only
    _, nt, ps = tfmt.validate_container(blob)
    return sym, blob, nt, ps


def _jax_mono(blob, nt, ps, s, c):
    return np.asarray(jlz_decode_mono.lz_decode_mono_pallas(
        jnp.asarray(blob), jnp.asarray(nt), jnp.asarray(ps), symbol_size=s,
        chunk_symbols=c, n_chunks=nt.size, interpret=True))


@pytest.mark.parametrize("s,w,c", [(1, 32, 64), (2, 128, 128), (4, 255, 64), (2, 64, 256)])
def test_decode_mono_plain_equals_pallas_and_xla(s, w, c):
    sym, blob, nt, ps = _container(s, w, c, 3, seed=c + s)
    got = lz_decode_mono.lz_decode_mono_plain(
        torch.from_numpy(blob)[None], torch.from_numpy(nt)[None], torch.from_numpy(ps)[None],
        symbol_size=s, chunk_symbols=c)[0]
    assert np.array_equal(got.numpy(), _jax_mono(blob, nt, ps, s, c))
    xla = jpipe.decompress_chunks(jnp.asarray(blob), jnp.asarray(nt), jnp.asarray(ps),
                                  symbol_size=s, chunk_symbols=c, n_chunks=3,
                                  decoder="xla-parallel")
    assert np.array_equal(got.numpy(), np.asarray(xla))
    assert np.array_equal(got.numpy(), sym.numpy())


@pytest.mark.parametrize("cut", [1, 3, 7])
def test_decode_mono_plain_reads_zeros_past_the_end(cut):
    """A blob cut short of its live end (its tables unchanged) makes the
    last chunk's last literals read past the blob: zeros on every lane, as
    the reference's one-launch decoder reads them."""
    s, c = 2, 128
    _, blob, nt, ps = _container(s, 64, c, 3, seed=cut)
    short = blob[: blob.size - cut]
    got = lz_decode_mono.lz_decode_mono_plain(
        torch.from_numpy(short)[None], torch.from_numpy(nt)[None],
        torch.from_numpy(ps)[None], symbol_size=s, chunk_symbols=c)[0]
    want = _jax_mono(short, nt, ps, s, c)
    assert np.array_equal(got.numpy(), want)
    full = _jax_mono(blob, nt, ps, s, c)
    assert not np.array_equal(want, full)  # the cut bytes were read


def test_decode_mono_plain_batch_of_live_bytes():
    """Three containers of one geometry padded to the longest: each row
    decodes as it does alone."""
    s, c = 4, 64
    conts = [_container(s, 255, c, 4, seed=k) for k in range(3)]
    width = max(b.size for _, b, _, _ in conts)
    blobs = np.zeros((3, width), np.uint8)
    for i, (_, b, _, _) in enumerate(conts):
        blobs[i, : b.size] = b
    got = lz_decode_mono.lz_decode_mono_plain(
        torch.from_numpy(blobs), torch.from_numpy(np.stack([t[2] for t in conts])),
        torch.from_numpy(np.stack([t[3] for t in conts])), symbol_size=s, chunk_symbols=c)
    for i, (sym, b, nt, ps) in enumerate(conts):
        assert np.array_equal(got[i].numpy(), sym.numpy())
        assert np.array_equal(got[i].numpy(), _jax_mono(b, nt, ps, s, c))


# ------------------------------------------------------ match-only kernel


@pytest.mark.parametrize("s,w,c", [(1, 32, 64), (2, 128, 128), (4, 255, 64), (2, 7, 256)])
def test_match_plain_equals_pallas(s, w, c):
    sym = _symbols(s, 3, c, seed=w)
    got = lz_match.lz_match_plain(sym, window=w, symbol_size=s)
    want = jlz_match.lz_match_pallas(jnp.asarray(sym.numpy()), window=w, interpret=True)
    for g, wnt in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(wnt))


# ---------------------------------------------------------- the host API


@pytest.mark.parametrize("name", GOLDEN_RAW)
def test_golden_corpus_through_the_new_entries(name):
    s, w, c = map(int, re.fullmatch(r"\w+?_s(\d)_w(\d+)_c(\d+)", name).groups())
    raw = np.frombuffer((GOLDEN / f"{name}.input.bin").read_bytes(), np.uint8)
    gold = np.frombuffer((GOLDEN / f"{name}.gplz").read_bytes(), np.uint8)
    for backend in ("fused-mono", "fused", "cuda-match"):
        cfg = tcore.LZSSConfig(backend=backend, **_cfg(s, w, c))
        assert np.array_equal(tcore.compress(raw, cfg, device=CPU).data, gold), backend
    for blob in (gold, (GOLDEN / "v1" / f"{name}.gplz").read_bytes()):
        assert np.array_equal(tcore.decompress(blob, decoder="fused-mono", device=CPU), raw)


@pytest.mark.parametrize("backend", ["fused-mono", "fused", "cuda-match"])
@pytest.mark.parametrize("s,w,c", [(1, 255, 64), (4, 32, 128)])
def test_containers_cross_both_ways(backend, s, w, c):
    raw = _bytes(np.random.default_rng(c), "noisy-tail", 3 * c * s + 5)
    tblob = tcore.compress(raw, tcore.LZSSConfig(backend=backend, **_cfg(s, w, c)),
                           device=CPU).data
    assert np.array_equal(np.asarray(jlzss.decompress(tblob)), raw)
    jblob = jlzss.compress(raw, jlzss.LZSSConfig(**_cfg(s, w, c))).data
    assert np.array_equal(tcore.decompress(jblob, decoder="fused-mono", device=CPU), raw)


def test_one_call_per_batch(monkeypatch):
    """One call of each one-launch wrapper per compress_many /
    decompress_many (and per compress / decompress), and no split-kernel
    wrapper call, as the reference's one-pallas_call test shows for its
    kernels."""
    calls = dict.fromkeys(ops.KERNELS, 0)
    for name in ops.KERNELS:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    rng = np.random.default_rng(3)
    arrays = [_bytes(rng, "runs", n) for n in (900, 256, 611)]
    cfg = tcore.LZSSConfig(backend="fused-mono", decoder="fused-mono",
                           **_cfg(2, 128, 64))
    many = tcore.compress_many(arrays, cfg, device=CPU)
    back = tcore.decompress_many(many, decoder="fused-mono", device=CPU)
    assert all(np.array_equal(o, a) for o, a in zip(back, arrays))
    one = tcore.compress(arrays[0], cfg, device=CPU)
    assert np.array_equal(tcore.decompress(one.data, decoder="fused-mono", device=CPU),
                          arrays[0])
    assert calls == dict(dict.fromkeys(ops.KERNELS, 0), lz_fused_mono=2, lz_decode_mono=2)


@pytest.mark.parametrize("backend,decoder,want", [
    ("deflate-full", "deflate-full", dict(lz_fused_mono=1, lz_decode=1)),
    ("lossy-fz", "lossy-fz", dict(lz_fused_mono=1, lz_decode_mono=1)),
])
def test_containers_run_their_lzss_through_the_hook(monkeypatch, backend, decoder, want):
    """With the one-launch pair as the device's default (as on a card), the
    deflate-full and lossy-fz containers run their inner LZSS through its
    compress_many hook and decode their raw inner containers through its
    decode_many hook, with the same bytes as the plain path."""
    x = np.cumsum(np.random.default_rng(9).normal(size=3000)).astype(np.float32)
    kw = dict(lossy_eb=0.0) if backend == "lossy-fz" else {}
    cfg = tcore.LZSSConfig(symbol_size=4, chunk_symbols=64, backend=backend, **kw)
    plain = tcore.compress(x, cfg, device=CPU).data
    monkeypatch.setattr(tpipe, "default_backend", lambda device: "fused-mono")
    monkeypatch.setattr(tpipe, "default_decoder", lambda device: "fused-mono")
    calls = dict.fromkeys(ops.KERNELS, 0)
    for name in ("lz_fused_mono", "lz_decode_mono", "lz_decode", "lz_kernel1"):
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    res = tcore.compress(x, cfg, device=CPU)
    assert np.array_equal(res.data, plain)
    assert np.array_equal(tcore.decompress(res.data, decoder=decoder, device=CPU).view(np.float32), x)
    assert calls == dict(dict.fromkeys(ops.KERNELS, 0), **want)
