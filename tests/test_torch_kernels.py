"""The port's kernel wrappers against the reference package.

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held to the reference here: Kernel I to ``repro.kernels.ref.lz_kernel1``,
Kernel II to the interpret-mode Pallas ``lz_global_offsets_pallas`` and to
``deflate.global_offsets``, Kernel III to the sections of the reference's
``emit_xla`` container, and the decoder to the interpret-mode Pallas
``lz_decode_pallas`` and to ``decode.decode_parallel``, the byte histogram
to the interpret-mode Pallas ``byte_histogram_pallas`` and the XLA
scatter-add, the gap decoder to the interpret-mode Pallas
``huffman_gap_decode_pallas`` (every lane) and the XLA ``decode_section``,
and the bitshuffle pair to the interpret-mode Pallas kernels and
``shuffle_xla`` / ``unshuffle_xla``.  (The reference's Pallas Kernels I and
III do not run on the installed jax.)  Outputs are integers: the tolerance
is exact equality.  The CUDA kernels themselves
are held to these plain versions on the card by tests/test_torch_gpu.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitshuffle as jbs
from repro.core import decode as jdecode
from repro.core import deflate as jdeflate
from repro.core import entropy as jent
from repro.core import format as jfmt
from repro.core import pipeline as jpipe
from repro.kernels import lz_bitshuffle as jlz_bitshuffle
from repro.kernels import lz_decode as jlz_decode
from repro.kernels import lz_entropy as jlz_entropy
from repro.kernels import lz_scatter as jlz_scatter
from repro.kernels import ref as jref
from repro_torch.core import autotune, deflate as tdeflate, entropy as tent, pipeline as tpipe
from repro_torch.kernels import _build, ops

from _torch_threads import _one_thread  # noqa: F401

GEOMETRIES = [(1, 32, 64), (2, 128, 128), (4, 255, 64), (2, 64, 256)]


def _np(x):
    return (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).astype(np.int64)


def _symbols(s, nc, c, seed):
    rng = np.random.default_rng(seed)
    n = nc * c * s
    raw = np.repeat(rng.integers(0, 5, n), rng.integers(1, 7, n)).astype(np.uint8)[:n]
    raw[: n // 5] = rng.integers(0, 256, n // 5)  # an incompressible stretch
    return tpipe.pack_symbols(torch.from_numpy(raw), s).reshape(nc, c)


def _kernel1(sym, s, w, device="cpu"):
    cfg = tpipe.LZSSConfig(symbol_size=s, window=w, chunk_symbols=sym.shape[1])
    return ops.lz_kernel1(sym.to(device), window=w, min_match=cfg.min_match, symbol_size=s), cfg


@pytest.mark.parametrize("s,w,c", GEOMETRIES)
def test_kernel1_plain_equals_reference(s, w, c):
    sym = _symbols(s, 3, c, seed=c + s)
    got, cfg = _kernel1(sym, s, w)
    want = jref.lz_kernel1(jnp.asarray(sym.numpy()), window=w, min_match=cfg.min_match,
                           symbol_size=s)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(_np(got[k]), _np(want[k])), k


@pytest.mark.parametrize("nc", [1, 5, 300])
def test_kernel2_plain_equals_reference(nc):
    rng = np.random.default_rng(nc)
    nt = rng.integers(1, 2048, (2, nc)).astype(np.int32)
    ps = rng.integers(1, 4096, (2, nc)).astype(np.int32)
    fo, po, tot = ops.lz_global_offsets(torch.from_numpy(nt), torch.from_numpy(ps))
    for r in range(2):
        jfo, jpo, jft, jpt = jlz_scatter.lz_global_offsets_pallas(
            jnp.asarray(nt[r]), jnp.asarray(ps[r]), interpret=True
        )
        assert np.array_equal(_np(fo[r]), _np(jfo)[:nc])
        assert np.array_equal(_np(po[r]), _np(jpo)[:nc])
        assert _np(tot[r]).tolist() == [int(jft), int(jpt)]
        pay_off, pay_tot, flag_off, flag_tot = jdeflate.global_offsets(
            jnp.asarray(ps[r]), (jnp.asarray(nt[r]) + 7) // 8
        )
        assert np.array_equal(_np(fo[r]), _np(flag_off))
        assert np.array_equal(_np(po[r]), _np(pay_off) + int(flag_tot))


@pytest.mark.parametrize("s,w,c", GEOMETRIES)
def test_kernel3_plain_equals_reference_emit(s, w, c):
    nc = 4
    sym = _symbols(s, nc, c, seed=7 * c + s)
    k1, cfg = _kernel1(sym, s, w)
    fo, po, tot = ops.lz_global_offsets(k1["n_tokens"][None], k1["payload_sizes"][None])
    cap = jfmt.max_compressed_bytes(nc * c * s, s, c)
    sec = jfmt.HEADER_BYTES + 8 * nc
    blob = ops.lz_scatter(
        sym[None], k1["lengths"][None], k1["offsets"][None], k1["emitted"][None],
        k1["local_off"][None], fo, po, symbol_size=s, min_match=cfg.min_match,
        cap=cap, sec_flags=sec,
    )
    jcfg = jpipe.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c)
    jk1 = jpipe.get_backend("xla").kernel1(jnp.asarray(sym.numpy()), jcfg)
    want, total = jpipe.emit_xla(jnp.asarray(sym.numpy()), jk1, jcfg)
    want = np.asarray(want)
    assert int(total) == sec + int(tot[0].sum())
    assert blob.shape == (1, cap)
    assert np.array_equal(blob[0, sec:].numpy(), want[sec:])  # header/tables: host work
    assert not blob[0, :sec].any()


def _sections(s, w, c, nc, seed):
    sym = _symbols(s, nc, c, seed)
    blob, total = tpipe.compress_chunks(sym, tpipe.LZSSConfig(symbol_size=s, window=w,
                                                              chunk_symbols=c))
    _, nt, ps = jfmt.validate_container(blob[:total].numpy())
    nt, ps = torch.from_numpy(nt), torch.from_numpy(ps)
    fs = (nt + 7) // 8
    sec = jfmt.HEADER_BYTES + 8 * nc
    flags = tdeflate.gather_section(blob, sec, fs, torch.cumsum(fs, 0) - fs, c // 8)
    pay = tdeflate.gather_section(blob, sec + int(fs.sum()), ps,
                                  torch.cumsum(ps, 0) - ps, c * s)
    return flags, pay, nt, sym


@pytest.mark.parametrize("s,w,c", GEOMETRIES)
def test_decoder_plain_equals_reference(s, w, c):
    flags, pay, nt, sym = _sections(s, w, c, 3, seed=c)
    got = ops.lz_decode(flags, pay, nt, symbol_size=s)
    args = [jnp.asarray(x.numpy().astype(np.int32)) for x in (flags, pay, nt)]
    assert np.array_equal(_np(got), _np(jlz_decode.lz_decode_pallas(*args, symbol_size=s,
                                                                    interpret=True)))
    assert np.array_equal(_np(got), _np(jdecode.decode_parallel(*args, symbol_size=s)))
    assert np.array_equal(_np(got), _np(sym))


def test_plain_versions_are_not_counted_as_launches():
    ops.reset_launch_counts()
    sym = _symbols(2, 2, 64, seed=1)
    for backend in ("fused-deflate", "fused-mono", "fused", "cuda-match"):
        blob, total = tpipe.compress_chunks(sym, tpipe.LZSSConfig(chunk_symbols=64,
                                                                 backend=backend))
    _, nt, ps = jfmt.validate_container(blob[:total].numpy())
    tpipe.decompress_chunks(blob, torch.from_numpy(nt), torch.from_numpy(ps), symbol_size=2,
                            chunk_symbols=64, n_chunks=2, decoder="fused-mono")
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_wrappers_refuse_other_devices():
    meta = torch.empty(2, 64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.lz_kernel1(meta, window=8, min_match=2, symbol_size=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.lz_decode(meta.to(torch.uint8), meta, meta[:, 0], symbol_size=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.lz_match(meta, window=8, symbol_size=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.lz_fused_mono(meta[None], window=8, min_match=2, symbol_size=2, cap=4096,
                          sec_flags=48)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.lz_decode_mono(meta.to(torch.uint8), meta, meta, symbol_size=2, chunk_symbols=64)
    flat = torch.empty(1024, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.byte_histogram(flat, 0, 10)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.huffman_gap_decode(flat, flat, flat, flat, flat, flat, flat, sub=512)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.bitshuffle(flat.view(torch.int16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.bitunshuffle(flat)


# ------------------------------------------------ entropy and bitshuffle


@pytest.mark.parametrize("start,length", [(0, 5000), (17, 3000), (4999, 1), (100, 0)])
def test_histogram_plain_equals_reference(start, length):
    buf = np.random.default_rng(1).integers(0, 256, 5000).astype(np.uint8)
    got = ops.byte_histogram(torch.from_numpy(buf), start, length)
    want = jent.byte_histogram(jnp.asarray(buf, jnp.int32), start, length, impl="xla")
    assert np.array_equal(_np(got), _np(want))
    if start == 17:  # the Pallas kernel in interpret mode is slow: one range
        pal = jlz_entropy.byte_histogram_pallas(jnp.asarray(buf, jnp.int32), start, length,
                                                interpret=True)
        assert np.array_equal(_np(got), _np(pal))


def _coded_section(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        sec = np.repeat(rng.integers(0, 30, n), rng.integers(1, 5, n)).astype(np.uint8)[:n]
    elif kind == "one-symbol":
        sec = np.full(n, 200, np.uint8)
    else:  # an exactly flat histogram: the stored escape
        sec = np.tile(np.arange(256, dtype=np.uint8), n // 256 + 1)[:n]
    lengths = tent.container_code_lengths(np.bincount(sec, minlength=256))
    # one capacity for every case: the reference's scan compiles per shape
    stream, nbits, gaps = tent.encode_section(torch.from_numpy(sec), 0, n, lengths, cap=1536)
    return sec, lengths, stream, gaps, nbits


def test_gap_decode_plain_equals_pallas_on_every_lane():
    sec, lengths, stream, gaps, nbits = _coded_section("skewed", 700, seed=3)
    tabs = tent.canonical_tables(lengths)
    # the live stream at byte 5, nothing after it: reads past the end are zeros
    blob = torch.cat([torch.zeros(5, dtype=torch.uint8), stream[: (nbits + 7) // 8]])
    gaps = gaps[:2]
    wstarts, rems = 5 + (gaps >> 3), (gaps & 7).to(torch.int32)
    args = [tabs[k] for k in ("first", "count", "base", "order")]
    got = ops.huffman_gap_decode(blob, wstarts, rems, *args, sub=512)
    want = jlz_entropy.huffman_gap_decode_pallas(
        jnp.asarray(blob.numpy(), jnp.int32), jnp.asarray(wstarts.numpy(), jnp.int32),
        jnp.asarray(rems.numpy()), *(jnp.asarray(a.numpy()) for a in args),
        sub=512, interpret=True,
    )
    assert got.shape == (2, 512)
    assert np.array_equal(_np(got), _np(want))  # the partial sub-block's tail too
    assert np.array_equal(got.reshape(-1)[:700].numpy(), sec)


@pytest.mark.parametrize("kind,n", [("skewed", 1500), ("one-symbol", 600), ("escape", 768),
                                    ("skewed", 513)])
def test_gap_decode_plain_equals_reference_scan(kind, n):
    sec, lengths, stream, gaps, _ = _coded_section(kind, n, seed=n)
    got = tent.decode_section(stream, 0, gaps, lengths, count=n, cap=1536)
    want = jent.decode_section(jnp.asarray(stream.numpy(), jnp.int32), 0,
                               jnp.asarray(gaps.numpy(), jnp.int32),
                               jnp.asarray(lengths, jnp.int32), count=n, cap=1536, impl="xla")
    assert np.array_equal(_np(got), _np(want))
    assert np.array_equal(got.numpy()[:n], sec)


@pytest.mark.parametrize("nblocks", [1, 2])
def test_bitshuffle_plain_equals_reference(nblocks):
    units = np.random.default_rng(nblocks).integers(0, 1 << 16, 512 * nblocks).astype(np.uint16)
    got = ops.bitshuffle(torch.from_numpy(units.view(np.int16).copy()))
    assert np.array_equal(_np(got), _np(jbs.shuffle_xla(jnp.asarray(units))))
    back = ops.bitunshuffle(got)
    assert np.array_equal(back.numpy().view(np.uint16),
                          np.asarray(jbs.unshuffle_xla(jnp.asarray(got.numpy()))))
    if nblocks == 2:  # the Pallas kernels in interpret mode
        pal = jlz_bitshuffle.bitshuffle_pallas(jnp.asarray(units), interpret=True)
        assert np.array_equal(_np(got), _np(pal))
        unpal = jlz_bitshuffle.bitunshuffle_pallas(pal, interpret=True)
        assert np.array_equal(back.numpy().view(np.uint16), np.asarray(unpal))


def test_bindings_match_the_cuda_sources():
    """Every ctypes signature names an extern "C" entry point of its source
    with as many parameters as it declares, each of the declared C type
    (a pointer, an int or a long long), and every header a source includes
    is in csrc/."""
    ctype = {"void*": _build._P, "int": _build._I, "long long": _build._L}
    for name, fns in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
            assert m, fn
            params = [" ".join(p.split()) for p in m.group(1).split(",")]
            assert len(params) == len(argtypes), fn
            for p, t in zip(params, argtypes):
                decl = re.sub(r"^const |\s*\w+$", "", p).replace(" *", "*")
                assert ctype[decl] is t, (fn, p)
        for header in re.findall(r'#include "([^"]+)"', src):
            assert (_build.CSRC / header).is_file(), (name, header)
    assert sorted(_build.SIGNATURES) == sorted(_build.SOURCES)
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
    assert len(_build.SOURCES) == 7 and len(ops.KERNELS) == 11


@pytest.mark.parametrize("s,c,fits", [(4, 32768, True), (1, 32768, True),
                                      (2, 58000, False), (4, 40000, False),
                                      (4, 38568, True), (4, 38576, False),
                                      (1, 57856, True), (2, 57856, True)])
def test_shared_memory_fit(s, c, fits):
    """The fit covers every kernel, the one-launch compressor's rows (Kernel
    I's, with the emit flags and flag words where the symbols were) too,
    and that term rejects no geometry the other kernels take."""
    mono = max(c * s, c + 4 * -(-c // 32)) + 2 * c
    assert autotune.kernel_smem_bytes(c, s) >= mono
    assert autotune.kernel_smem_bytes(c, s) == max(c * s + 2 * c, 4 * c)
    if fits:
        autotune.validate_block_geometry(c, 8, s)
    else:
        with pytest.raises(ValueError, match=f"chunk_symbols={c}"):
            autotune.validate_block_geometry(c, 8, s)
