"""The port's deflate-full stage (core/entropy.py) against the reference.

Host code lengths, canonical tables, ``encode_section`` / ``decode_section``
and whole method-1 containers of repro_torch are held to their repro
counterparts on the same seeded numpy inputs, on the CPU (the wrappers run
the kernels' plain versions there).  Everything compared is an integer or
a container byte: the tolerance is exact equality.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import entropy as jent
from repro.core import format as jfmt
from repro.core import lzss as jlzss
from repro_torch import core as tcore
from repro_torch.core import entropy as tent
from repro_torch.core import format as tfmt

from _torch_threads import _one_thread  # noqa: F401

CPU = "cpu"
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
SUB = 1 << tfmt.DEFAULT_SUB_LOG2


def _hist(d):
    h = np.zeros(256, np.int64)
    for k, v in d.items():
        h[k] = v
    return h


HISTS = {
    "single-symbol": _hist({7: 1000}),
    "two-symbols": _hist({0: 1, 255: 1}),
    "all-equal": np.full(256, 3, np.int64),
    "one-dominant": _hist({0: 1 << 20, **{i: 1 for i in range(1, 40)}}),
    "fibonacci-skew": _hist({i: f for i, f in enumerate(
        [1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610, 987, 1597, 2584,
         4181, 6765, 10946, 17711, 28657, 46368])}),
    "powers-of-two": _hist({i: 1 << i for i in range(20)}),
    "sparse-tail": _hist({250 + i: 10**i for i in range(5)}),
    "empty": np.zeros(256, np.int64),
}


def _section(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        return np.repeat(rng.integers(0, 40, n), rng.integers(1, 4, n)).astype(np.uint8)[:n]
    if kind == "one-symbol":
        return np.full(n, 9, np.uint8)
    if kind == "escape":  # an exactly flat histogram: the 8-bit identity code
        return np.tile(np.arange(256, dtype=np.uint8), n // 256 + 1)[:n]
    return rng.integers(0, 256, n).astype(np.uint8)


# ------------------------------------------------------ host code lengths


@pytest.mark.parametrize("name", sorted(HISTS))
def test_code_lengths_equal_reference(name):
    counts = HISTS[name]
    if counts.any():
        assert np.array_equal(tent.huffman_code_lengths(counts), jent.huffman_code_lengths(counts))
        assert np.array_equal(tent.huffman_code_lengths(counts, max_len=15),
                              jent.huffman_code_lengths(counts, max_len=15))
    got = tent.container_code_lengths(counts)
    assert np.array_equal(got, jent.container_code_lengths(counts))
    # the reference's in-graph mirror, which its compressor runs
    assert np.array_equal(got, np.asarray(jent.container_code_lengths_jax(counts)))


@pytest.mark.parametrize("name", sorted(HISTS))
def test_canonical_tables_equal_reference(name):
    lengths = jent.container_code_lengths(HISTS[name])
    got = tent.canonical_tables(lengths)
    want = jent.canonical_tables_jax(jnp.asarray(lengths, jnp.int32))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert np.array_equal(tent.canonical_codes(lengths), jent.canonical_codes(lengths))
    assert np.array_equal(got["codes"].numpy(), tent.canonical_codes(lengths))


def test_stored_escape_and_limit():
    noise = np.bincount(_section("noise", 600, 3), minlength=256)
    flat = np.bincount(_section("escape", 768, 0), minlength=256)
    assert (tent.container_code_lengths(flat) == tent.STORED_LEN).all()
    for counts in (noise, HISTS["fibonacci-skew"]):
        l = tent.container_code_lengths(counts)
        assert l.max() <= tent.MAX_CODE_LEN
        assert int((counts * l).sum()) <= 8 * int(counts.sum())


# ----------------------------------------------------- section transcode

# one capacity for all: the reference runs these eagerly, compiling per shape
SECTIONS = [("skewed", 1500, 1536), ("one-symbol", 600, 1536), ("escape", 768, 1536),
            ("noise", 600, 1536), ("skewed", 513, 1536), ("skewed", 1, 1536)]


@pytest.mark.parametrize("kind,n,cap", SECTIONS)
def test_encode_section_equals_reference(kind, n, cap):
    sec = _section(kind, n, seed=n)
    buf = np.pad(sec, (5, 4))  # the section at an unaligned start
    lengths = jent.container_code_lengths(np.bincount(sec, minlength=256))
    stream, nbits, gaps = tent.encode_section(torch.from_numpy(buf), 5, n, lengths, cap=cap)
    jstream, jnbits, jgaps = jent.encode_section(
        jnp.asarray(buf, jnp.int32), 5, n, jnp.asarray(lengths, jnp.int32), cap=cap
    )
    assert nbits == int(jnbits) == int((np.bincount(sec, minlength=256) * lengths).sum())
    assert np.array_equal(stream.numpy(), np.asarray(jstream))
    assert np.array_equal(gaps.numpy(), np.asarray(jgaps))


@pytest.mark.parametrize("kind,n,cap", SECTIONS)
def test_decode_section_equals_reference(kind, n, cap):
    sec = _section(kind, n, seed=n)
    lengths = jent.container_code_lengths(np.bincount(sec, minlength=256))
    jstream, _, jgaps = jent.encode_section(
        jnp.asarray(sec, jnp.int32), 0, n, jnp.asarray(lengths, jnp.int32), cap=cap
    )
    blob = np.concatenate([np.zeros(3, np.uint8), np.asarray(jstream).astype(np.uint8)])  # writable
    got = tent.decode_section(torch.from_numpy(blob), 3, torch.from_numpy(np.array(jgaps)),
                              lengths, count=n, cap=cap)
    want = jent.decode_section(jnp.asarray(blob, jnp.int32), 3, jgaps,
                               jnp.asarray(lengths, jnp.int32), count=n, cap=cap, impl="xla")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy()[:n], sec) and not got[n:].any()


# ---------------------------------------------------- whole containers

# S=2 is held to the reference by the golden i16 container below; the
# reference compiles once per (S, n_chunks), which these corpora share
CORPORA = {
    "u8-runs": (1, lambda rng: np.repeat(rng.integers(0, 12, 400),
                                         rng.integers(1, 6, 400)).astype(np.uint8)[:1200]),
    "f32-waves": (4, lambda rng: np.sin(np.linspace(0, 8, 500)).astype(np.float32)),
    "i32-ramp": (4, lambda rng: (np.arange(400, dtype=np.int32) * 7) % 512),
    "empty": (1, lambda rng: np.zeros(0, np.uint8)),
    "one-byte": (1, lambda rng: np.array([170], np.uint8)),
}


def _cfgs(s, backend="deflate-full", window=64):
    kw = dict(symbol_size=s, window=window, chunk_symbols=128, backend=backend)
    return jlzss.LZSSConfig(**kw), tcore.LZSSConfig(**kw)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_containers_byte_identical_and_cross(name):
    s, make = CORPORA[name]
    data = make(np.random.default_rng(5))
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    jcfg, tcfg = _cfgs(s)
    want = jlzss.compress(data, jcfg)
    got = tcore.compress(data, tcfg, device=CPU)
    assert (got.total_bytes, got.orig_bytes) == (want.total_bytes, want.orig_bytes)
    assert np.array_equal(got.data, want.data)
    h = tfmt.parse_header(got.data)
    assert (h.method, h.sub_log2) == (tfmt.METHOD_HUFFMAN, tfmt.DEFAULT_SUB_LOG2)
    assert np.array_equal(tcore.decompress(want.data, device=CPU), raw)
    assert np.array_equal(np.asarray(jlzss.decompress(got.data)), raw)


@pytest.mark.parametrize("name", ["u8_s1_w32_c64_deflate", "i16_s2_w128_c128_deflate",
                                  "f32_s4_w64_c64_deflate"])
def test_golden_deflate_containers(name):
    s, w, c = {"u8": (1, 32, 64), "i16": (2, 128, 128), "f32": (4, 64, 64)}[name.split("_")[0]]
    raw = np.frombuffer((GOLDEN / f"{name}.input.bin").read_bytes(), np.uint8)
    gold = np.frombuffer((GOLDEN / f"{name}.gplz").read_bytes(), np.uint8)
    cfg = tcore.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c, backend="deflate-full")
    assert np.array_equal(tcore.compress(raw, cfg, device=CPU).data, gold)
    assert np.array_equal(tcore.decompress(gold, device=CPU), raw)
    assert np.array_equal(tcore.decompress(gold, decoder="deflate-full", device=CPU), raw)


def test_plain_impl_equals_default_path():
    data = CORPORA["u8-runs"][1](np.random.default_rng(2))
    _, tcfg = _cfgs(1)
    sym = tcore.pack_symbols(torch.from_numpy(np.pad(data, (0, 80))), 1).reshape(-1, 128)
    buf, total = tcore.compress_chunks(sym, tcfg, data.size)
    pbuf, ptotal = tent.compress_entropy(sym, tcfg, data.size, impl="plain")
    assert total == ptotal and torch.equal(buf, pbuf)
    h = tfmt.parse_header(buf[:total].numpy())
    got = tent.decode_blob_entropy(buf[:total], h, impl="plain")
    assert torch.equal(got, sym)


def test_compress_many_equals_reference():
    # sizes of one chunk count (10 at C=128): each row is then the single
    # container, whose reference compile the u8-runs case above shares
    rng = np.random.default_rng(10)
    items = [np.repeat(rng.integers(0, 9, 500), 3).astype(np.uint8)[:1200],
             rng.integers(0, 5, 1280).astype(np.uint8), np.zeros(1153, np.uint8)]
    jcfg, tcfg = _cfgs(1)
    got = tcore.compress_many(items, tcfg, device=CPU)
    for i, item in enumerate(items):
        want = jlzss.compress(item, jcfg)
        assert got.total_bytes[i] == want.total_bytes
        assert np.array_equal(got[i].data, want.data)
        assert not got.data[i, want.total_bytes:].any()
        assert np.array_equal(np.asarray(jlzss.decompress(got[i].data)), item)
    outs = tcore.decompress_many(got, device=CPU)
    assert all(np.array_equal(o, i) for o, i in zip(outs, items))


# -------------------------------------------------- routing and guards


def _messages(fn_j, fn_t):
    with pytest.raises(ValueError) as je:
        fn_j()
    with pytest.raises(ValueError) as te:
        fn_t()
    assert str(te.value) == str(je.value)


def test_config_normalization_equals_reference():
    jcfg, tcfg = _cfgs(2)
    assert tcfg.decoder == jcfg.decoder == "deflate-full"
    _messages(lambda: jlzss.LZSSConfig(decoder="deflate-full"),
              lambda: tcore.LZSSConfig(decoder="deflate-full"))
    assert tcore.container_method("deflate-full") == tfmt.METHOD_HUFFMAN
    assert tcore.container_method("auto") == tfmt.METHOD_RAW


def test_wrong_decoders_raise_as_the_reference():
    data = np.arange(500, dtype=np.uint8)
    jcfg, tcfg = _cfgs(1, window=32)
    ent = tcore.compress(data, tcfg, device=CPU).data
    raw = tcore.compress(data, tcore.LZSSConfig(symbol_size=1, window=32, chunk_symbols=128),
                         device=CPU).data
    for jdec, tdec in (("fused", "fused"), ("xla-parallel", "torch-parallel"),
                       ("xla-scan", "torch-scan")):
        with pytest.raises(ValueError) as je:
            jlzss.decompress(ent, decoder=jdec)
        with pytest.raises(ValueError) as te:
            tcore.decompress(ent, decoder=tdec, device=CPU)
        assert str(te.value) == str(je.value).replace(jdec, tdec)
    _messages(lambda: jlzss.decompress(raw, decoder="deflate-full"),
              lambda: tcore.decompress(raw, decoder="deflate-full", device=CPU))
    _messages(lambda: jlzss.decompress_many([ent, raw]),
              lambda: tcore.decompress_many([ent, raw], device=CPU))
    _messages(lambda: jlzss.decompress_many([raw], decoder="deflate-full"),
              lambda: tcore.decompress_many([raw], decoder="deflate-full", device=CPU))


def test_corrupt_entropy_metadata_raises():
    data = np.repeat(np.arange(20, dtype=np.uint8), 60)
    _, tcfg = _cfgs(1)
    blob = tcore.compress(data, tcfg, device=CPU).data
    h = tfmt.parse_header(blob)
    bad = blob.copy()
    bad[h.sec_meta : h.sec_meta + 128] = 0x11  # 256 one-bit codes: Kraft oversubscribed
    with pytest.raises(ValueError, match="corrupted container"):
        tcore.decompress(bad, device=CPU)
    for cut in (1, 8, blob.size // 2):
        with pytest.raises(ValueError):
            tcore.decompress(blob[:-cut], device=CPU)
    padded = np.concatenate([blob, np.zeros(99, np.uint8)])
    assert np.array_equal(tcore.decompress(padded, device=CPU), data)


def test_entropy_bound_holds_on_incompressible_input():
    data = np.random.default_rng(4).integers(0, 256, 4096).astype(np.uint8)
    _, tcfg = _cfgs(1)
    res = tcore.compress(data, tcfg, device=CPU)
    assert res.total_bytes <= jfmt.entropy_max_compressed_bytes(4096, 1, 128)
    assert np.array_equal(tcore.decompress(res.data, device=CPU), data)
