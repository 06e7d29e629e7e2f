"""The port's codec modules against the reference package, on the CPU.

match / encode / deflate / decode / quant / pipeline / lzss of repro_torch
are held to their repro counterparts on the same seeded numpy inputs.  All
outputs are integers (or container bytes), so the tolerance is exact
equality.  The reference compressor is the ``xla`` backend: every method-0
backend of the reference emits the same bytes.
"""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode as jdecode
from repro.core import deflate as jdeflate
from repro.core import encode as jencode
from repro.core import lzss as jlzss
from repro.core import match as jmatch
from repro.core import pipeline as jpipe
from repro.core import quant as jquant
from repro_torch import core as tcore
from repro_torch.core import decode as tdecode
from repro_torch.core import deflate as tdeflate
from repro_torch.core import encode as tencode
from repro_torch.core import format as tfmt
from repro_torch.core import match as tmatch
from repro_torch.core import pipeline as tpipe
from repro_torch.core import quant as tquant

CPU = "cpu"
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
GOLDEN_RAW = sorted(
    p.name[: -len(".input.bin")]
    for p in GOLDEN.glob("*.input.bin")
    if re.fullmatch(r"[a-z0-9]+_s\d_w\d+_c\d+", p.name[: -len(".input.bin")])
)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _bytes(rng, kind, n):
    """Seeded test inputs with LZ structure: runs, repeats and noise."""
    if kind == "runs":
        return np.repeat(rng.integers(0, 6, n), rng.integers(1, 9, n)).astype(np.uint8)[:n]
    if kind == "repeat":
        base = rng.integers(0, 256, 37).astype(np.uint8)
        return np.tile(base, n // 37 + 1)[:n]
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    return rng.integers(0, 256, n).astype(np.uint8)


def _symbols(s, nc, c, seed, kind="runs"):
    raw = _bytes(np.random.default_rng(seed), kind, nc * c * s)
    sym = tpipe.pack_symbols(torch.from_numpy(raw), s).reshape(nc, c)
    return sym, jnp.asarray(sym.numpy())


# ------------------------------------------------------------------ match


@pytest.mark.parametrize("s,w,c", [(1, 32, 64), (2, 128, 128), (4, 255, 256), (4, 7, 64)])
@pytest.mark.parametrize("kind", ["runs", "repeat", "noise"])
def test_find_matches_equals_reference(s, w, c, kind):
    t, j = _symbols(s, 3, c, seed=c + w, kind=kind)
    tl, to = tmatch.find_matches(t, window=w)
    jl, jo = jmatch.find_matches(j, window=w)
    assert _eq(tl, jl) and _eq(to, jo)


def test_find_matches_brute_force_oracle():
    t, _ = _symbols(2, 2, 48, seed=5)
    tl, to = tmatch.find_matches(t, window=20)
    rl, ro = tmatch.find_matches_reference(t.numpy(), window=20)
    jl, jo = jmatch.find_matches_reference(t.numpy(), window=20)
    assert _eq(tl, rl) and _eq(to, ro) and _eq(rl, jl) and _eq(ro, jo)
    assert tmatch.MAX_LEN_CAP == jmatch.MAX_LEN_CAP


# ----------------------------------------------------------------- encode


@pytest.mark.parametrize("s", [1, 2, 4])
def test_selection_and_fields_equal_reference(s):
    t, j = _symbols(s, 4, 128, seed=s)
    mm = tencode.min_match_length(s)
    assert mm == jencode.min_match_length(s)
    lengths, _ = tmatch.find_matches(t, window=64)
    jlen = jnp.asarray(lengths.numpy())
    scan = tencode.select_tokens_scan(lengths, min_match=mm)
    dbl = tencode.select_tokens_doubling(lengths, min_match=mm)
    assert _eq(scan, jencode.select_tokens_scan(jlen, min_match=mm))
    assert _eq(dbl, jencode.select_tokens_doubling(jlen, min_match=mm))
    tf = tencode.token_fields(lengths, scan, min_match=mm, symbol_size=s)
    jf = jencode.token_fields(jlen, jnp.asarray(scan.numpy()), min_match=mm, symbol_size=s)
    for k in jf:
        assert _eq(tf[k], jf[k]), k


# ---------------------------------------------------------------- deflate


def _kernel1_fields(s, w, c, nc, seed):
    t, j = _symbols(s, nc, c, seed)
    k1 = tpipe.get_backend("torch", CPU).kernel1(t, tpipe.LZSSConfig(
        symbol_size=s, window=w, chunk_symbols=c))
    jk1 = {k: jnp.asarray(v.numpy()) for k, v in k1.items()}
    return t, j, k1, jk1


@pytest.mark.parametrize("s", [1, 2, 4])
def test_deflate_ops_equal_reference(s):
    t, j, k1, jk1 = _kernel1_fields(s, 64, 64, 5, seed=10 + s)
    tfb, tfs = tdeflate.pack_flags(k1["emitted"], k1["use_match"])
    jfb, jfs = jdeflate.pack_flags(jk1["emitted"], jk1["use_match"])
    assert _eq(tfb, jfb) and _eq(tfs, jfs)
    tp = tdeflate.build_chunk_payloads(t, k1["lengths"], k1["offsets"], k1, symbol_size=s)
    jp = jdeflate.build_chunk_payloads(j, jk1["lengths"], jk1["offsets"], jk1, symbol_size=s)
    assert _eq(tp, jp)
    tg = tdeflate.global_offsets(k1["payload_sizes"], tfs)
    jg = jdeflate.global_offsets(jk1["payload_sizes"], jfs)
    for a, b in zip(tg, jg):
        assert _eq(a, b)
    cap = 48 + int(tfs.sum()) + int(k1["payload_sizes"].sum()) + 16
    tout = tdeflate.scatter_section(torch.zeros(cap, dtype=torch.int32), 48, tp,
                                    k1["payload_sizes"], tg[0])
    jout = jdeflate.scatter_section(jnp.zeros((cap,), jnp.int32), 48, jp,
                                    jk1["payload_sizes"], jg[0])
    assert _eq(tout, jout)
    back_t = tdeflate.gather_section(tout, 48, k1["payload_sizes"], tg[0], 64 * s)
    back_j = jdeflate.gather_section(jout, 48, jk1["payload_sizes"], jg[0], 64 * s)
    assert _eq(back_t, back_j) and _eq(back_t, tp)


# ----------------------------------------------------------------- decode


def _sections(s, w, c, nc, seed, kind="runs"):
    raw = _bytes(np.random.default_rng(seed), kind, nc * c * s)
    blob = jlzss.compress(raw, jlzss.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c)).data
    h, nt, ps = tfmt.validate_container(blob)
    flat = torch.from_numpy(blob.astype(np.int32))
    fs = (torch.from_numpy(nt) + 7) // 8
    fo = torch.cumsum(fs, 0) - fs
    po = torch.cumsum(torch.from_numpy(ps), 0) - torch.from_numpy(ps)
    sec = tfmt.HEADER_BYTES + 8 * nc
    flags = tdeflate.gather_section(flat, sec, fs, fo, c // 8)
    pay = tdeflate.gather_section(flat, sec + int(fs.sum()), torch.from_numpy(ps), po, c * s)
    sym = tpipe.pack_symbols(torch.from_numpy(raw), s).reshape(nc, c)
    return flags, pay, torch.from_numpy(nt), sym


@pytest.mark.parametrize("s,w,c", [(1, 32, 64), (2, 128, 128), (4, 255, 64)])
@pytest.mark.parametrize("kind", ["runs", "noise", "zeros"])
def test_decoders_equal_reference(s, w, c, kind):
    flags, pay, nt, sym = _sections(s, w, c, 3, seed=c, kind=kind)
    jf, jp, jn = (jnp.asarray(x.numpy()) for x in (flags, pay, nt))
    tp = tdecode.decode_parallel(flags, pay, nt, symbol_size=s)
    ts = tdecode.decode_scan(flags, pay, nt, symbol_size=s)
    assert _eq(tp, jdecode.decode_parallel(jf, jp, jn, symbol_size=s))
    assert _eq(ts, jdecode.decode_scan(jf, jp, jn, symbol_size=s))
    assert _eq(tp, sym) and _eq(ts, sym)


# ------------------------------------------------------------------ quant


@pytest.mark.parametrize("ndim", [1, 2])
def test_quantize_equals_reference(ndim):
    rng = np.random.default_rng(ndim)
    x = np.cumsum(rng.normal(0, 1, (24, 40)), axis=1).astype(np.float32)
    x[3, 5] = np.nan
    x[7, 9] = 1e12  # saturates to an outlier
    eb = tquant.relative_error_bound(x[np.isfinite(x) & (x < 1e6)], 1e-3)
    assert eb == jquant.relative_error_bound(x[np.isfinite(x) & (x < 1e6)], 1e-3)
    tq = tquant.quantize(torch.from_numpy(x), error_bound=eb, ndim=ndim)
    jq = jquant.quantize(jnp.asarray(x), error_bound=eb, ndim=ndim)
    assert _eq(tq.codes, jq.codes)
    assert _eq(tq.outlier_mask, jq.outlier_mask)
    assert np.array_equal(_np(tq.outlier_vals), np.asarray(jq.outlier_vals), equal_nan=True)
    if ndim == 1:
        td = tquant.dequantize(tq.codes, tq.outlier_mask, tq.outlier_vals, error_bound=eb)
        jd = jquant.dequantize(jq.codes, jq.outlier_mask, jq.outlier_vals, error_bound=eb)
        assert np.array_equal(_np(td).view(np.uint32), np.asarray(jd).view(np.uint32))


# --------------------------------------------------------------- pipeline


@pytest.mark.parametrize("s", [1, 2, 4])
def test_pack_unpack_symbols_equal_reference(s):
    raw = np.random.default_rng(s).integers(0, 256, 64 * s).astype(np.uint8)
    t = tpipe.pack_symbols(torch.from_numpy(raw), s)
    j = jpipe.pack_symbols(jnp.asarray(raw), s)
    assert _eq(t, j)  # at S=4, negative int32 bit patterns included
    assert np.array_equal(tpipe.unpack_symbols(t, s).numpy(), raw)


@pytest.mark.parametrize("kw", [
    dict(symbol_size=3), dict(window=0), dict(window=256), dict(chunk_symbols=60),
    dict(chunks_per_block=0), dict(decoder="nope"),
])
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as je:
        jpipe.LZSSConfig(**kw)
    with pytest.raises(ValueError) as te:
        tpipe.LZSSConfig(**kw)
    if "decoder" not in kw:
        assert str(te.value) == str(je.value)


def test_config_rejects_chunks_over_shared_memory():
    tpipe.LZSSConfig(symbol_size=4, chunk_symbols=32768)
    with pytest.raises(ValueError, match="chunk_symbols=65536"):
        tpipe.LZSSConfig(symbol_size=4, chunk_symbols=65536)


@pytest.mark.parametrize("backend,want", [
    ("xla", "auto"), ("pallas-match", "auto"), ("fused", "auto"),
    ("fused-deflate", "auto"), ("fused-mono", "auto"), ("xla-scan", "torch-scan"),
])
def test_config_from_jax_maps_raw_family(backend, want):
    j = jpipe.LZSSConfig(symbol_size=4, window=77, chunk_symbols=256, backend=backend,
                         decoder="xla-scan")
    t = tpipe.config_from_jax(dataclasses.asdict(j))
    assert (t.symbol_size, t.window, t.chunk_symbols) == (4, 77, 256)
    assert t.backend == want and t.decoder == "torch-scan"


@pytest.mark.parametrize("fields,item", [
    (dict(backend="deflate-full"), "item 7"),
    (dict(backend="lossy-fz", symbol_size=4, lossy_eb=1e-3), "item 8"),
    (dict(decoder="sharded"), "item 9"),
])
def test_config_from_jax_rejects_queued_entries(fields, item):
    j = jpipe.LZSSConfig(**fields)
    with pytest.raises(ValueError, match=item):
        tpipe.config_from_jax(dataclasses.asdict(j))


def test_auto_resolves_by_device():
    assert tpipe.resolve_backend("auto", "cpu") == "torch"
    assert tpipe.resolve_backend("auto", "cuda") == "fused-deflate"
    assert tpipe.resolve_decoder("auto", "cpu") == "torch-parallel"
    assert tpipe.resolve_decoder("auto", "cuda") == "fused"
    assert tpipe.resolve_decoder("scan", "cpu") == "torch-scan"
    assert tcore.available_backends() == ["fused-deflate", "torch", "torch-scan"]
    assert tcore.available_decoders() == ["fused", "torch-parallel", "torch-scan"]


def test_host_api_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = tcore.compress(np.arange(100, dtype=np.uint8), device=CPU).data
    for call in (lambda: tcore.compress(b"abc"), lambda: tcore.decompress(blob),
                 lambda: tcore.compress_many([b"abc"]), lambda: tcore.decompress_many([blob])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -------------------------------------------------------------- whole path


CASES = [
    ("empty", 0, 2, 64, 64),
    ("one_byte", 1, 4, 32, 64),
    ("not_multiple_of_s", 1001, 4, 128, 128),
    ("mid_chunk_s2", 3 * 256 + 100, 2, 64, 128),
    ("mid_chunk_s1", 5000, 1, 255, 256),
    ("noise_s4", 4096, 4, 255, 64),
]


def _case_bytes(label, n):
    kind = "noise" if "noise" in label else "runs"
    return _bytes(np.random.default_rng(n + len(label)), kind, n)


@pytest.mark.parametrize("label,n,s,w,c", CASES)
@pytest.mark.parametrize("backend", ["torch", "torch-scan", "fused-deflate"])
def test_containers_byte_identical_to_reference(label, n, s, w, c, backend):
    raw = _case_bytes(label, n)
    want = jlzss.compress(raw, jlzss.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c))
    got = tcore.compress(raw, tcore.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c,
                                               backend=backend), device=CPU)
    assert got.total_bytes == want.total_bytes and got.orig_bytes == want.orig_bytes
    assert np.array_equal(got.data, want.data)


@pytest.mark.parametrize("label,n,s,w,c", CASES)
@pytest.mark.parametrize("decoder", ["torch-parallel", "torch-scan", "fused"])
def test_containers_cross_both_ways(label, n, s, w, c, decoder):
    raw = _case_bytes(label, n)
    cfg = dict(symbol_size=s, window=w, chunk_symbols=c)
    jblob = jlzss.compress(raw, jlzss.LZSSConfig(**cfg)).data
    tblob = tcore.compress(raw, tcore.LZSSConfig(**cfg), device=CPU).data
    assert np.array_equal(tcore.decompress(jblob, decoder=decoder, device=CPU), raw)
    assert np.array_equal(np.asarray(jlzss.decompress(tblob)), raw)


def test_compress_many_equals_reference_and_crosses():
    rng = np.random.default_rng(7)
    arrays = [_bytes(rng, "runs", n) for n in (300, 1024, 17, 700)]
    cfg = dict(symbol_size=2, window=64, chunk_symbols=128)
    want = jlzss.compress_many(arrays, jlzss.LZSSConfig(**cfg))
    for backend in ("torch", "fused-deflate"):
        got = tcore.compress_many(arrays, tcore.LZSSConfig(backend=backend, **cfg), device=CPU)
        assert np.array_equal(got.data, want.data)
        assert np.array_equal(got.total_bytes, want.total_bytes)
        assert got.ratio == want.ratio
    for decoder in ("torch-parallel", "fused"):
        outs = tcore.decompress_many([want[i].data for i in range(len(want))],
                                     decoder=decoder, device=CPU)
        assert all(np.array_equal(o, a) for o, a in zip(outs, arrays))
    assert all(np.array_equal(o, a) for o, a in zip(tcore.decompress_many(got, device=CPU), arrays))
    back = jlzss.decompress_many([got[i].data for i in range(len(got))])
    assert all(np.array_equal(np.asarray(o), a) for o, a in zip(back, arrays))


def test_chunk_level_cores_equal_reference():
    t, j = _symbols(4, 3, 64, seed=3)
    cfg = dict(symbol_size=4, window=50, chunk_symbols=64)
    tb, tt = tcore.compress_chunks(t, tcore.LZSSConfig(**cfg), 700)
    jb, jt = jpipe.compress_chunks(j, jpipe.LZSSConfig(**cfg), jnp.int32(700))
    assert tt == int(jt) and np.array_equal(tb.numpy(), np.asarray(jb))
    _, nt, ps = tfmt.validate_container(tb[:tt].numpy())
    sym = tcore.decompress_chunks(tb, torch.from_numpy(nt), torch.from_numpy(ps),
                                  symbol_size=4, chunk_symbols=64, n_chunks=3)
    assert _eq(sym, t)


@pytest.mark.parametrize("name", GOLDEN_RAW)
def test_golden_corpus_compresses_to_checked_in_bytes(name):
    s, w, c = map(int, re.fullmatch(r"\w+?_s(\d)_w(\d+)_c(\d+)", name).groups())
    raw = np.frombuffer((GOLDEN / f"{name}.input.bin").read_bytes(), np.uint8)
    gold = np.frombuffer((GOLDEN / f"{name}.gplz").read_bytes(), np.uint8)
    for backend in ("torch", "fused-deflate"):
        cfg = tcore.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c, backend=backend)
        assert np.array_equal(tcore.compress(raw, cfg, device=CPU).data, gold)
    for blob in (gold, (GOLDEN / "v1" / f"{name}.gplz").read_bytes()):
        assert np.array_equal(tcore.decompress(blob, device=CPU), raw)


def test_golden_corpus_is_complete():
    assert len(GOLDEN_RAW) == 7


@pytest.mark.parametrize("name", ["u8_s1_w32_c64_deflate", "f32_s4_w64_c64_lossy"])
def test_unported_container_methods_raise(name):
    blob = (GOLDEN / f"{name}.gplz").read_bytes()
    with pytest.raises(ValueError, match="not ported yet"):
        tcore.decompress(blob, device=CPU)


def test_decompress_many_rejects_mixed_geometry():
    a = tcore.compress(np.zeros(500, np.uint8), tcore.LZSSConfig(chunk_symbols=64), device=CPU)
    b = tcore.compress(np.zeros(500, np.uint8), tcore.LZSSConfig(chunk_symbols=128), device=CPU)
    with pytest.raises(ValueError, match="homogeneous batch geometry"):
        tcore.decompress_many([a.data, b.data], device=CPU)
    with pytest.raises(ValueError, match="buffer 1: truncated"):
        tcore.decompress_many([a.data, b.data[:30]], device=CPU)


def test_host_api_takes_tensors():
    raw = _bytes(np.random.default_rng(3), "runs", 3000)
    want = tcore.compress(raw, device=CPU)
    as_u16 = torch.from_numpy(raw.copy()).view(torch.int16)
    got = tcore.compress(as_u16, device=CPU)
    assert np.array_equal(got.data, want.data) and got.orig_bytes == 3000
    assert np.array_equal(tcore.decompress(torch.from_numpy(got.data), device=CPU), raw)
