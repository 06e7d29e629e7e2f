"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks for a card in its fixture and skips without
one.  This file imports no JAX, so it runs where only PyTorch and the CUDA
toolkit are installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Outputs are integers: the tolerance is exact equality, except the values
of lossy-fz containers, which are held to their error bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.core import deflate, entropy, format as fmt, pipeline as pl
from repro_torch.data import (
    bitshuffle_edges, datasets, decode_edges, offsets_edges, scatter_edges, walk_edges)
from repro_torch.kernels import (
    _build, lz_bitshuffle, lz_decode, lz_decode_mono, lz_entropy, lz_fused, lz_match, lz_scatter, ops)

GEOMETRIES = [(1, 32, 64), (2, 128, 128), (4, 255, 64), (4, 128, 2048), (2, 255, 32768)]
LZSS_KERNELS = ("lz_kernel1", "lz_global_offsets", "lz_scatter", "lz_decode")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the H100; see README)")
    return torch.device("cuda")


def _symbols(s, nc, c, seed):
    rng = np.random.default_rng(seed)
    n = nc * c * s
    raw = np.repeat(rng.integers(0, 5, n), rng.integers(1, 7, n)).astype(np.uint8)[:n]
    raw[: n // 5] = rng.integers(0, 256, n // 5)  # an incompressible stretch
    return pl.pack_symbols(torch.from_numpy(raw), s).reshape(nc, c)


@pytest.mark.gpu
@pytest.mark.parametrize("s,w,c", GEOMETRIES)
def test_kernel_path_equals_plain_path(cuda, s, w, c):
    nc = 3
    sym = _symbols(s, nc, c, seed=c).to(cuda)
    ops.reset_launch_counts()
    blob, total = pl.compress_chunks(
        sym, core.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c, backend="fused-deflate"))
    plain, plain_total = pl.compress_chunks(
        sym, core.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c, backend="torch")
    )
    assert total == plain_total and torch.equal(blob, plain)
    _, nt, ps = fmt.validate_container(blob[:total].cpu().numpy())
    tables = (torch.from_numpy(nt).to(cuda), torch.from_numpy(ps).to(cuda))
    kw = dict(symbol_size=s, chunk_symbols=c, n_chunks=nc)
    got = pl.decompress_chunks(blob[:total], *tables, decoder="fused", **kw)
    want = pl.decompress_chunks(blob[:total], *tables, decoder="torch-parallel", **kw)
    assert torch.equal(got, want) and torch.equal(got, sym.to(torch.int32))
    counts = ops.launch_counts()
    assert {k: counts[k] for k in LZSS_KERNELS} == dict.fromkeys(LZSS_KERNELS, 1)


@pytest.mark.gpu
def test_host_api_defaults_to_the_card(cuda):
    """The default on the card is the one-launch pair: one launch per
    compress and per decompress, and no split kernel."""
    data = np.random.default_rng(0).integers(0, 4, 100_000).astype(np.uint8)
    ops.reset_launch_counts()
    res = core.compress(data)
    assert np.array_equal(core.decompress(res.data), data)
    counts = ops.launch_counts()
    assert counts == dict(dict.fromkeys(ops.KERNELS, 0), lz_fused_mono=1, lz_decode_mono=1)
    assert np.array_equal(res.data, core.compress(data, device="cpu").data)


# ----------------------------------- the one-launch pair and the matcher

# C=2048 at S in {1, 2, 4}, C=32768, and the largest chunks the shared-memory
# fit accepts at S=4 and S=1
MONO_GEOMETRIES = [(1, 32, 2048), (2, 128, 2048), (4, 255, 2048), (2, 128, 32768),
                   (4, 128, 32768), (4, 128, 38568), (1, 32, 57856)]


@pytest.mark.gpu
@pytest.mark.parametrize("s,w,c", MONO_GEOMETRIES)
def test_mono_kernels_equal_plain_and_split(cuda, s, w, c):
    """The one-launch compressor equals its plain version and the split
    kernels' blob on a ragged-looking batch of 3 buffers; the one-launch
    decoder equals its plain version on blobs that hold only their live
    bytes, and inverts the compressor."""
    nc = 3
    sym = torch.stack([_symbols(s, nc, c, seed=c + k) for k in range(3)]).to(cuda)
    mm = core.LZSSConfig(symbol_size=s, chunk_symbols=c).min_match
    kw = dict(window=w, min_match=mm, symbol_size=s,
              cap=fmt.max_compressed_bytes(nc * c * s, s, c), sec_flags=fmt.HEADER_BYTES + 8 * nc)
    got = lz_fused.lz_fused_mono_cuda(sym, **kw)
    want = lz_fused.lz_fused_mono_plain(sym, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cfg = core.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c, backend="fused-deflate")
    split, totals = pl.compress_many_chunks(sym, cfg)
    mono, mono_totals = pl.compress_many_chunks(
        sym, core.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c, backend="fused-mono"))
    assert mono_totals == totals and torch.equal(mono, split)
    width = max(totals)  # each row holds only its live bytes, zeros past them
    blobs = torch.stack([torch.nn.functional.pad(mono[i, : totals[i]], (0, width - totals[i]))
                         for i in range(3)])
    dargs = (blobs, got[1], got[2])
    d = lz_decode_mono.lz_decode_mono_cuda(*dargs, symbol_size=s, chunk_symbols=c)
    assert torch.equal(d, lz_decode_mono.lz_decode_mono_plain(*dargs, symbol_size=s,
                                                                 chunk_symbols=c))
    assert torch.equal(d, sym.to(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("s,w", [(1, 32), (2, 128), (4, 255)])
def test_match_kernel_equals_plain(cuda, s, w):
    sym = _symbols(s, 8, 2048, seed=w).to(cuda)
    got = lz_match.lz_match_cuda(sym, window=w, symbol_size=s)
    want = lz_match.lz_match_plain(sym, window=w, symbol_size=s)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_one_launch_per_batch_call(cuda):
    rng = np.random.default_rng(4)
    arrays = [rng.integers(0, 3, n).astype(np.uint8) for n in (50_000, 7_000, 33_333)]
    ops.reset_launch_counts()
    many = core.compress_many(arrays)
    back = core.decompress_many(many)
    assert all(np.array_equal(o, a) for o, a in zip(back, arrays))
    counts = ops.launch_counts()
    assert counts == dict(dict.fromkeys(ops.KERNELS, 0), lz_fused_mono=1, lz_decode_mono=1)
    ops.reset_launch_counts()
    res = core.compress(arrays[0], core.LZSSConfig(backend="cuda-match"))
    assert np.array_equal(res.data, many[0].data)
    assert ops.launch_counts()["lz_match"] == 1


# ------------------------------------------------ the window walk's edges

# (S, W, C): W=1, the main path's S=2 W=128, the 255 cap at W=255, and the
# largest chunks the shared-memory fit accepts (38,568 is not a multiple of
# 32, so its last word is partial)
WALK_GEOMETRIES = [(1, 1, 2048), (2, 128, 2048), (2, 255, 2048), (4, 255, 2048),
                   (4, 128, 38568), (1, 255, 57856)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", walk_edges.KINDS)
@pytest.mark.parametrize("s,w,c", WALK_GEOMETRIES)
def test_walk_kernels_equal_plain_on_walk_edges(cuda, kind, s, w, c):
    """The three kernels that walk the window (the match-only kernel, Kernel
    I, the one-launch compressor) equal their plain versions on runs that
    cross words and tiles, reach the cap or the chunk's end, tie, and on
    all-equal symbols and two-symbol noise."""
    nc = 2 if c > 2048 else 8
    sym = torch.from_numpy(walk_edges.walk_edge_symbols(kind, nc, c, s, w)).to(cuda)
    got = lz_match.lz_match_cuda(sym, window=w, symbol_size=s)
    want = lz_match.lz_match_plain(sym, window=w, symbol_size=s)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    kw = dict(window=w, min_match=core.LZSSConfig(symbol_size=s).min_match, symbol_size=s)
    k1, p1 = lz_match.lz_kernel1_cuda(sym, **kw), lz_match.lz_kernel1_plain(sym, **kw)
    assert all(torch.equal(k1[k], p1[k]) for k in p1)
    kw.update(cap=fmt.max_compressed_bytes(nc * c * s, s, c), sec_flags=fmt.HEADER_BYTES + 8 * nc)
    mono = lz_fused.lz_fused_mono_cuda(sym[None], **kw)
    assert all(torch.equal(a, b) for a, b in zip(mono, lz_fused.lz_fused_mono_plain(sym[None], **kw)))


# ------------------------------------------------ the decoders' edges

# (S, C): C=8 and the main path's C=2048 at every S (the decode chain's
# staged layout), and the largest chunks the shared-memory fit accepts (its
# rows layout)
DECODE_GEOMETRIES = [(1, 8), (2, 8), (4, 8), (1, 2048), (2, 2048), (4, 2048), (4, 38568),
                     (1, 57856)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", decode_edges.LZ_KINDS)
@pytest.mark.parametrize("s,c", DECODE_GEOMETRIES)
def test_decoders_equal_plain_on_decode_edges(cuda, kind, s, c):
    """The split and the one-launch decoder equal their plain versions, and
    decode the symbols, on literal-only chunks, the deepest copy chain, a
    partial last tile of tokens and mixed runs."""
    nc = 2 if c > 2048 else 8
    sym, blob, nt, ps = (torch.from_numpy(x).to(cuda) for x in
                         decode_edges.lz_edge_container(kind, nc, c, s, device=cuda))
    fs, p64 = (nt.to(torch.int64) + 7) // 8, ps.to(torch.int64)
    sec = fmt.HEADER_BYTES + 8 * nc
    flags = deflate.gather_section(blob, sec, fs, torch.cumsum(fs, 0) - fs, c // 8)
    pay = deflate.gather_section(blob, sec + int(fs.sum()), p64, torch.cumsum(p64, 0) - p64, c * s)
    got = lz_decode.lz_decode_cuda(flags, pay, nt, symbol_size=s)
    assert torch.equal(got, lz_decode.lz_decode_plain(flags, pay, nt, symbol_size=s))
    assert torch.equal(got, sym)
    args = (blob[None], nt[None], ps[None])
    kw = dict(symbol_size=s, chunk_symbols=c)
    got = lz_decode_mono.lz_decode_mono_cuda(*args, **kw)
    assert torch.equal(got, lz_decode_mono.lz_decode_mono_plain(*args, **kw))
    assert torch.equal(got[0], sym)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", decode_edges.GAP_KINDS)
def test_gap_decoder_equals_plain_on_gap_edges(cuda, kind):
    """The gap decoder equals its plain version on every lane of a code with
    15-bit codewords, the stored escape, one symbol, partial last
    sub-blocks and blocks whose stream is staged in more than one round,
    each stream ending at its blob's last byte."""
    inp = decode_edges.gap_edge_inputs(kind, device=cuda)
    args = [inp[k] for k in ("blob", "wstarts", "rems", "first", "count", "base", "order")]
    got = lz_entropy.huffman_gap_decode_cuda(*args, sub=decode_edges.SUB)
    assert torch.equal(got, lz_entropy.huffman_gap_decode_plain(*args, sub=decode_edges.SUB))
    sec = inp["section"]
    assert np.array_equal(got.reshape(-1)[: sec.size].cpu().numpy(), sec)


# ------------------------------------------------ entropy and lossy stages


def _section(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        return np.repeat(rng.integers(0, 40, n), rng.integers(1, 9, n)).astype(np.uint8)[:n]
    if kind == "one-symbol":
        return np.full(n, 9, np.uint8)
    return np.tile(np.arange(256, dtype=np.uint8), n // 256 + 1)[:n]  # stored escape


@pytest.mark.gpu
@pytest.mark.parametrize("start,length", [(0, 1 << 20), (3, 1000), (17, (1 << 20) - 40), (5, 0)])
def test_histogram_kernel_equals_plain(cuda, start, length):
    buf = torch.from_numpy(_section("skewed", 1 << 20, seed=1)).to(cuda)
    got = lz_entropy.byte_histogram_cuda(buf, start, length)
    assert torch.equal(got, lz_entropy.byte_histogram_plain(buf, start, length))
    want = torch.bincount(buf[start : start + length].long(), minlength=256).to(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n", [("skewed", 70_000), ("one-symbol", 1500), ("escape", 2000),
                                    ("skewed", 513)])
def test_gap_decode_kernel_equals_plain(cuda, kind, n):
    sec = _section(kind, n, seed=n)
    buf = torch.from_numpy(sec).to(cuda)
    counts = np.bincount(sec, minlength=256)
    l = entropy.container_code_lengths(counts)
    stream, nbits, gaps = entropy.encode_section(buf, 0, n, l, cap=n)
    assert nbits == int((counts * l).sum())
    nbytes = (nbits + 7) // 8
    blob = stream[:nbytes].contiguous()  # reads past the stream's end give zeros
    tabs = entropy.canonical_tables(l, cuda)
    nsub = -(-n // 512)
    args = (blob, gaps[:nsub] >> 3, (gaps[:nsub] & 7).to(torch.int32), tabs["first"],
            tabs["count"], tabs["base"], tabs["order"])
    got = lz_entropy.huffman_gap_decode_cuda(*args, sub=512)
    assert torch.equal(got, lz_entropy.huffman_gap_decode_plain(*args, sub=512))
    assert np.array_equal(got.reshape(-1)[:n].cpu().numpy(), sec)


BITSHUFFLE_CASES = [(p, n) for p in bitshuffle_edges.PATTERNS for n in bitshuffle_edges.BLOCK_COUNTS]
BITSHUFFLE_CASES += [("random", 65536), ("random", 65537), ("one-hot", bitshuffle_edges.ONE_HOT_BLOCKS)]


def _edge_units(pattern, nblocks, device):
    if pattern == "one-hot":
        units = bitshuffle_edges.one_hot_units()
    else:
        units = bitshuffle_edges.edge_units(pattern, nblocks, seed=nblocks)
    return torch.from_numpy(units.view(np.int16).copy()).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern,nblocks", BITSHUFFLE_CASES)
def test_bitshuffle_kernels_equal_plain(cuda, pattern, nblocks):
    units = _edge_units(pattern, nblocks, cuda)
    shuffled = lz_bitshuffle.bitshuffle_cuda(units)
    assert torch.equal(shuffled, lz_bitshuffle.bitshuffle_plain(units))
    if pattern == "one-hot":
        assert np.array_equal(shuffled.cpu().numpy(), bitshuffle_edges.one_hot_expected())
    back = lz_bitshuffle.bitunshuffle_cuda(shuffled)
    assert torch.equal(back, lz_bitshuffle.bitunshuffle_plain(shuffled))
    assert torch.equal(back, units)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 2, 8])
def test_bitshuffle_entry_points_at_every_alignment(cuda, offset):
    """The C entry points on ragged block counts, with input and output at
    ``offset`` bytes from a 16-byte boundary (0: the vector path, else the
    byte path)."""
    from repro_torch.kernels import _build

    lib, st = _build.library("lz_bitshuffle"), torch.cuda.current_stream().cuda_stream
    tile = bitshuffle_edges.TILE_BLOCKS
    for nb in (1, tile - 1, tile + 1, 4097):
        units = _edge_units("random", nb, cuda)
        n = units.numel() * 2
        src, dst = (torch.zeros(n + 16, dtype=torch.uint8, device=cuda) for _ in range(2))
        src[offset : offset + n] = units.view(torch.uint8)
        assert lib.lz_bitshuffle_launch(src.data_ptr() + offset, nb, dst.data_ptr() + offset,
                                        st) == 0
        shuffled = dst[offset : offset + n].clone()
        assert torch.equal(shuffled, lz_bitshuffle.bitshuffle_plain(units))
        src.zero_()
        assert lib.lz_bitunshuffle_launch(dst.data_ptr() + offset, nb, src.data_ptr() + offset,
                                          st) == 0
        assert torch.equal(src[offset : offset + n], units.view(torch.uint8))
        assert not src[:offset].any() and not src[offset + n :].any()


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 8])
def test_bitshuffle_kernels_on_misaligned_views(cuda, offset):
    """A uint8 view at ``offset`` bytes into its storage for the inverse, an
    int16 view at a 1-unit offset for the shuffle, and ``out=`` views at the
    same offsets: exact on every one."""
    units = _edge_units("random", bitshuffle_edges.TILE_BLOCKS + 1, cuda)
    want = lz_bitshuffle.bitshuffle_plain(units)
    n = want.numel()
    ubuf = torch.zeros(units.numel() + 1, dtype=torch.int16, device=cuda)
    ubuf[1:] = units
    view = ubuf[1:]
    assert view.data_ptr() % 16 == 2
    assert torch.equal(lz_bitshuffle.bitshuffle_cuda(view), want)
    sbuf = torch.zeros(n + offset, dtype=torch.uint8, device=cuda)
    sbuf[offset:] = want
    sview = sbuf[offset:]
    assert sview.data_ptr() % 16 == offset
    assert torch.equal(lz_bitshuffle.bitunshuffle_cuda(sview), units)
    obuf = torch.zeros(n + offset + 5, dtype=torch.uint8, device=cuda)
    got = lz_bitshuffle.bitshuffle_cuda(view, out=obuf[offset:])
    assert got.data_ptr() % 16 == offset and torch.equal(got, want)
    assert not obuf[:offset].any() and not obuf[offset + n :].any()
    oubuf = torch.zeros(units.numel() + 3, dtype=torch.int16, device=cuda)
    back = lz_bitshuffle.bitunshuffle_cuda(sview, out=oubuf[1:])
    assert torch.equal(back, units) and not oubuf[0] and not oubuf[1 + units.numel() :].any()


@pytest.mark.gpu
def test_bitshuffle_kernels_into_out(cuda):
    """``out=`` into a larger zeroed buffer: the prefix exact, the tail zero,
    and one launch a shuffle."""
    units = _edge_units("random", 65537, cuda)
    want = lz_bitshuffle.bitshuffle_plain(units)
    buf = torch.zeros(want.numel() + 4096, dtype=torch.uint8, device=cuda)
    ubuf = torch.zeros(units.numel() + 100, dtype=torch.int16, device=cuda)
    ops.reset_launch_counts()
    got = ops.bitshuffle(units, buf)
    assert ops.launch_counts()["bitshuffle"] == 1
    back = lz_bitshuffle.bitunshuffle_cuda(got, out=ubuf)
    assert got.data_ptr() == buf.data_ptr() and torch.equal(got, want)
    assert not buf[want.numel() :].any()
    assert back.data_ptr() == ubuf.data_ptr() and torch.equal(back, units)
    assert not ubuf[units.numel() :].any()


@pytest.mark.gpu
def test_bitshuffle_occupancy(cuda):
    occ = lz_bitshuffle.bitshuffle_occupancy()
    assert set(occ) == {"bitshuffle", "bitunshuffle"}
    assert all(r > 0 and b >= 1 for r, b in occ.values())


# ------------------------------------ Kernel III and the histogram's edges


def _scatter_case(kind, c, s, device):
    nc = scatter_edges.chunks_for(c)
    x = scatter_edges.scatter_inputs(kind, 2, nc, c, s,
                                     seed=17 * c + 5 * s + scatter_edges.KINDS.index(kind))
    fo, po = scatter_edges.section_offsets(x["n_tokens"], x["payload_sizes"])
    args = [torch.from_numpy(x[k]).to(device) for k in
            ("symbols", "lengths", "offsets", "emitted", "local_off")]
    args += [torch.from_numpy(fo).to(device), torch.from_numpy(po).to(device)]
    kw = dict(symbol_size=s, min_match=scatter_edges.min_match(s),
              cap=fmt.max_compressed_bytes(nc * c * s, s, c), sec_flags=fmt.HEADER_BYTES + 8 * nc)
    return args, kw


@pytest.mark.gpu
@pytest.mark.parametrize("kind", scatter_edges.KINDS)
@pytest.mark.parametrize("c,s", scatter_edges.GEOMETRIES)
def test_scatter_kernel_equals_plain_on_edges(cuda, kind, c, s):
    args, kw = _scatter_case(kind, c, s, cuda)
    want = lz_scatter.scatter_plain(*args, **kw)
    assert torch.equal(lz_scatter.scatter_cuda(*args, **kw), want)
    args[3] = args[3].to(torch.uint8)  # emitted as bytes, not bools
    assert torch.equal(lz_scatter.scatter_cuda(*args, **kw), want)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 2, 4])
def test_scatter_layouts_at_the_edge(cuda, s):
    """The largest staged chunk and the next multiple of 8 take the two
    layouts; C=2048 at S=2 (the main path) is staged."""
    lo, hi = scatter_edges.layout_edge(s)
    assert lz_scatter.scatter_occupancy(chunk_symbols=lo, symbol_size=s)["layout"] == "staged"
    assert lz_scatter.scatter_occupancy(chunk_symbols=hi, symbol_size=s)["layout"] == "direct"
    occ = lz_scatter.scatter_occupancy(chunk_symbols=2048, symbol_size=2)
    assert occ["layout"] == "staged" and occ["registers"] > 0 and occ["blocks"] >= 1


@pytest.mark.gpu
def test_scatter_kernel_on_misaligned_views(cuda):
    """Fields at a storage offset are copied to a 16-byte boundary by the
    wrapper: the same blob."""
    args, kw = _scatter_case("mixed", 40, 2, cuda)
    want = lz_scatter.scatter_plain(*args, **kw)
    shifted = []
    for t in args:
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=cuda)
        buf[1:] = t.reshape(-1)
        shifted.append(buf[1:].reshape(t.shape))
    assert shifted[0].data_ptr() % 16 == 4
    assert torch.equal(lz_scatter.scatter_cuda(*shifted, **kw), want)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", scatter_edges.HIST_PATTERNS)
def test_histogram_kernel_equals_plain_on_edges(cuda, pattern):
    buf = torch.from_numpy(scatter_edges.histogram_bytes(pattern, 64, seed=3)).to(cuda)
    for start, length in scatter_edges.RANGES:
        got = lz_entropy.byte_histogram_cuda(buf, start, length)
        assert torch.equal(got, lz_entropy.byte_histogram_plain(buf, start, length)), (start, length)


@pytest.mark.gpu
@pytest.mark.parametrize("start", [0, 3])
def test_histogram_kernel_on_one_value_at_64_mib(cuda, start):
    n = scatter_edges.BIG_BYTES
    buf = torch.from_numpy(scatter_edges.histogram_bytes("one-value", n)).to(cuda)
    got = lz_entropy.byte_histogram_cuda(buf, start, n - start - 5)
    want = torch.zeros(256, dtype=torch.int32, device=cuda)
    want[0x7F] = n - start - 5
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_histogram_occupancy(cuda):
    regs, blocks = lz_entropy.histogram_occupancy()
    assert regs > 0 and blocks >= 1


# ------------------------------------------------------------- Kernel II


def _offsets_entry(nt, ps, out):
    """Kernel II through its C entry point into ``out``."""
    lib = _build.library("lz_scatter")
    rows, nc = nt.shape
    code = lib.lz_global_offsets_launch(nt.data_ptr(), ps.data_ptr(), rows, nc,
                                        *(t.data_ptr() for t in out),
                                        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return code


@pytest.mark.gpu
@pytest.mark.parametrize("nc", offsets_edges.NCS)
@pytest.mark.parametrize("kind", offsets_edges.KINDS)
def test_offsets_kernel_equals_plain_on_edges(cuda, kind, nc):
    """Through the wrapper and through the C entry point."""
    for rows in offsets_edges.ROWS:
        nt, ps = (torch.from_numpy(a).to(cuda) for a in
                  offsets_edges.offsets_inputs(kind, rows, nc))
        want = lz_scatter.global_offsets_plain(nt, ps)
        assert all(torch.equal(a, b) for a, b in zip(lz_scatter.global_offsets_cuda(nt, ps), want))
        out = tuple(torch.full_like(t, -7) for t in want)
        assert _offsets_entry(nt, ps, out) == 0
        assert all(torch.equal(a, w) for a, w in zip(out, want)), rows


@pytest.mark.gpu
@pytest.mark.parametrize("shift", offsets_edges.VIEW_BYTES)
def test_offsets_kernel_on_misaligned_views(cuda, shift):
    """The wrapper on input views at every 16-byte residue, alike and
    unlike; the C entry on four arrays at one residue: the same offsets,
    and no byte written outside."""
    view = offsets_edges.view_at
    for kind, rows, nc in (("random", 3, 1025), ("ragged", 8, 33), ("last", 1, 16385),
                           ("random", 1, 32769), ("literals", 8, 5), ("random", 3, 65541)):
        nt, ps = (torch.from_numpy(a).to(cuda) for a in
                  offsets_edges.offsets_inputs(kind, rows, nc))
        want = lz_scatter.global_offsets_plain(nt, ps)
        for a, b in ((view(nt, shift), view(ps, shift)), (view(nt, shift), ps),
                     (nt, view(ps, shift))):
            got = lz_scatter.global_offsets_cuda(a, b)
            assert all(torch.equal(x, w) for x, w in zip(got, want)), (kind, rows, nc)
        bufs = [torch.full((t.numel() + 8,), -7, dtype=torch.int32, device=cuda) for t in want]
        out = [buf[k : k + t.numel()].view(t.shape) for buf, t, k in
               zip(bufs, want, (shift // 4, shift // 4 + 4, 3))]
        assert _offsets_entry(view(nt, shift), view(ps, shift), out) == 0
        for buf, o, w in zip(bufs, out, want):
            assert torch.equal(o, w), (kind, rows, nc)
            assert int((buf != -7).sum()) == w.numel()


@pytest.mark.gpu
def test_offsets_entry_refuses_mixed_residues(cuda):
    """The C entry takes its four (rows, nc) arrays at one residue mod 16."""
    nt = torch.zeros(2, 5, dtype=torch.int32, device=cuda)
    view = offsets_edges.view_at
    out = [torch.full((2, 5), -7, dtype=torch.int32, device=cuda) for _ in range(2)]
    out.append(torch.full((2, 2), -7, dtype=torch.int32, device=cuda))
    for args in ((view(nt, 4), nt, out), (nt, view(nt, 8), out),
                 (nt, nt, [view(out[0], 12), out[1], out[2]]),
                 (nt, nt, [out[0], view(out[1], 4), out[2]])):
        assert _offsets_entry(*args) != 0
    assert all(bool((o == -7).all()) for o in out)


@pytest.mark.gpu
def test_offsets_occupancy(cuda):
    regs, blocks = lz_scatter.global_offsets_occupancy()
    assert 0 < regs <= 64 and blocks >= 1


def _field(n, seed):
    rng = np.random.default_rng(seed)
    x = (np.cumsum(rng.normal(size=n)) * 0.03 + np.sin(np.linspace(0, 20, n))).astype(np.float32)
    x[5:9] = [np.nan, np.inf, -np.inf, 1e30]
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 2, 4])
def test_deflate_full_on_the_card(cuda, s):
    data = _section("skewed", 300_000, seed=s)
    cfg = core.LZSSConfig(symbol_size=s, chunk_symbols=2048, backend="deflate-full")
    ops.reset_launch_counts()
    res = core.compress(data, cfg)
    assert np.array_equal(core.decompress(res.data), data)
    counts = ops.launch_counts()
    assert counts["byte_histogram"] == 2 and counts["huffman_gap_decode"] == 2
    assert np.array_equal(res.data, core.compress(data, cfg, device="cpu").data)


@pytest.mark.gpu
@pytest.mark.parametrize("eb,inner", [(1e-3, "auto"), (1e-3, "deflate-full"), (0.0, "auto")])
def test_lossy_fz_on_the_card(cuda, eb, inner):
    x = _field(200_000, seed=3)
    cfg = core.LZSSConfig(symbol_size=4, backend="lossy-fz", lossy_eb=eb, lossy_inner=inner)
    ops.reset_launch_counts()
    res = core.compress(x, cfg)
    y = core.decompress(res.data).view(np.float32)
    counts = ops.launch_counts()
    assert counts["bitshuffle"] == 1 and counts["bitunshuffle"] == 1
    if eb == 0.0:
        assert np.array_equal(y.view(np.uint32), x.view(np.uint32))
    else:
        fin = np.isfinite(x)
        assert np.abs(y[fin] - x[fin]).max() <= np.float32(eb)
        assert np.array_equal(y[~fin].view(np.uint32), x[~fin].view(np.uint32))
    assert np.array_equal(res.data, core.compress(x, cfg, device="cpu").data)


# ------------------------------------- tuner, batch layer, parameter selection


@pytest.fixture
def tuned(cuda, tmp_path, monkeypatch):
    """Tuning on, against a cache file of this test's own."""
    from repro_torch.core import autotune

    monkeypatch.setenv(autotune.ENABLE_ENV, "1")
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "SWEEP_BYTES", 4 << 20)
    autotune.reset()
    yield autotune
    autotune.reset()


@pytest.mark.gpu
def test_tuned_chunk_width_container_equals_plain(tuned):
    cfg = pl.tuned_config(2, 128)
    assert (cfg.chunk_symbols, cfg.chunks_per_block) in tuned.candidates(tuned.TuneKey(
        tuned.device_kind(), "u16", 2, 128, "compress", None))
    assert tuned._SWEEPS and tuned.device_kind() != "cpu"
    data = datasets.load("hurr-quant", 3 << 20)
    ops.reset_launch_counts()
    res = core.compress(data, dataclasses.replace(cfg, backend="fused-mono"))
    assert ops.launch_counts()["lz_fused_mono"] == 1
    plain = core.compress(data, dataclasses.replace(cfg, backend="torch"))
    assert np.array_equal(res.data, plain.data)
    assert np.array_equal(core.decompress(res.data), data)
    assert pl.tuned_config(2, 128) == cfg and len(tuned._SWEEPS) == 1
    tuned.reset()
    assert pl.tuned_config(2, 128) == cfg and tuned._SWEEPS == {}


@pytest.mark.gpu
def test_sharded_runner_on_one_card_twice_equals_unsharded(cuda):
    rng = np.random.default_rng(4)
    items = [datasets.load("hurr-quant", 1 << 20)[: (1 << 20) - 999 * i] for i in range(3)]
    items[2] = rng.integers(0, 256, 5000).astype(np.uint8)
    plain = core.compress_many(items, core.LZSSConfig())
    for mesh in ((cuda,), (cuda, cuda)):
        got = core.compress_many(items, core.LZSSConfig(backend="sharded", mesh=mesh))
        assert np.array_equal(got.data, plain.data)
        outs = core.decompress_many(got, mesh=mesh)
        assert all(np.array_equal(o, x) for o, x in zip(outs, items))
    ent = core.LZSSConfig(backend="deflate-full")
    want = core.compress_many(items, ent)
    got = core.compress_many(items, dataclasses.replace(ent, mesh=(cuda, cuda)))
    assert np.array_equal(got.data, want.data)
    outs = core.decompress_many(got, mesh=(cuda, cuda))
    assert all(np.array_equal(o, x) for o, x in zip(outs, items))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(datasets.DATASETS))
def test_param_selector_on_the_card_picks_as_on_cpu(cuda, name):
    data = datasets.load(name, 1 << 20)
    dtype = datasets.DATASETS[name][1]
    sel = {dev: core.ParamSelector(dtype=dtype) for dev in ("cuda", "cpu")}
    for half in (data[: data.size // 2], data[data.size // 2 :]):
        picks = {dev: s.observe(half, device=dev) for dev, s in sel.items()}
        assert picks["cuda"] == picks["cpu"]
    assert sel["cuda"].mean_ratio == sel["cpu"].mean_ratio
    assert sel["cuda"].current_config() == sel["cpu"].current_config()


@pytest.mark.gpu
def test_prefetcher_puts_batches_on_the_card(cuda):
    from repro_torch.data import pipeline as data_pipeline

    cfg = data_pipeline.DataConfig(vocab_size=32000, seq_len=256, global_batch=4, seed=1)
    pre = data_pipeline.Prefetcher(cfg, start_step=3, device=cuda)
    for step in range(3, 7):
        got = pre.next()["tokens"]
        assert got.device.type == "cuda" and got.dtype == torch.int32
        assert np.array_equal(got.cpu().numpy(), data_pipeline.make_batch_for_step(cfg, step)["tokens"])


# ------------------------------------------------------------- the models


def _model_cfg(name, dtype, no_drop=False):
    from repro_torch import configs

    cfg = dataclasses.replace(configs.reduced_config(configs.get_config(name)), dtype=dtype)
    if no_drop and cfg.moe is not None:  # decode routes as the forward does
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return cfg


MODEL_ARCHS = ["llama3.2-1b", "hymba-1.5b", "mamba2-2.7b", "deepseek-v2-236b",
               "llama4-scout-17b-a16e"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["llama3.2-1b", "hymba-1.5b", "llama4-scout-17b-a16e"])
def test_model_paged_decode_equals_dense_on_the_card(cuda, name):
    from repro_torch.models import model, transformer as tf

    cfg = _model_cfg(name, "bfloat16")
    m = model.init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (3, 8), generator=torch.Generator().manual_seed(1))
    caches = tf.init_cache(cfg, 3, 16, device=cuda)
    paged = tf.init_paged_cache(cfg, 3, 16, block_tokens=4, device=cuda)
    td = tp = toks[:, 0].to(cuda)
    for pos in range(16):
        ld, caches = tf.decode_step(m, cfg, caches, td, pos)
        lp, paged = tf.decode_step_paged(m, cfg, paged, tp, pos)
        assert torch.equal(ld, lp), pos
        td, tp = (toks[:, pos + 1].to(cuda),) * 2 if pos + 1 < 8 else (ld.argmax(-1), lp.argmax(-1))


@pytest.mark.gpu
@pytest.mark.parametrize("name", MODEL_ARCHS)
def test_model_decode_matches_forward_f32_on_the_card(cuda, name):
    from repro_torch.models import common, model, transformer as tf

    cfg = _model_cfg(name, "float32", no_drop=True)
    m = model.init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(2))
    toks = toks.to(cuda)
    with common.full_f32_matmul(), torch.no_grad():
        full = tf.unembed(m, cfg, tf.forward(m, cfg, tokens=toks, remat="none")[0])
        caches, outs = tf.init_cache(cfg, 2, 40, device=cuda), []
        for pos in range(40):
            outs.append(tf.decode_step(m, cfg, caches, toks[:, pos], pos)[0])
    err = float((torch.stack(outs, 1) - full).abs().max())
    assert err <= 1e-3 * max(1.0, float(full.abs().max())), err


@pytest.mark.gpu
@pytest.mark.parametrize("name", MODEL_ARCHS)
def test_model_on_the_card_matches_the_cpu(cuda, name):
    from repro_torch.models import common, convert, model, transformer as tf

    cfg = _model_cfg(name, "float32")
    on_cpu = model.init_params(cfg, 0, device="cpu")
    on_card = convert.params_from_numpy(convert.params_to_numpy(on_cpu), cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=torch.Generator().manual_seed(3))
    with common.full_f32_matmul(), torch.no_grad():
        want = tf.unembed(on_cpu, cfg, tf.forward(on_cpu, cfg, tokens=toks, remat="none")[0])
        got = tf.unembed(on_card, cfg, tf.forward(on_card, cfg, tokens=toks.to(cuda),
                                                  remat="none")[0])
    err = float((got.cpu() - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-4, err


def test_model_entry_points_raise_without_a_card():
    """Built on cuda by default: without a card they raise, never fall back
    to the CPU (runs where there is no card)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.models import model, transformer as tf

    cfg = _model_cfg("llama3.2-1b", "float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.make_batch(cfg, model.ShapeConfig("s", 8, 2, "train"))
    assert model.init_params(cfg, 0, device="cpu").embed.device.type == "cpu"


# ------------------------------------------------- serving and the optimizer


@pytest.mark.gpu
def test_serving_engine_paged_equals_dense_on_the_card(cuda):
    """The compressed paged tier on the card: tokens bit-identical to dense
    with prefetch off, on and async; one launch of the one-launch pair a
    round; the stored blobs those of the CPU store for the same blocks."""
    from repro_torch.models import model
    from repro_torch.serving import engine, kvcache

    cfg = _model_cfg("llama3.2-1b", "bfloat16")
    m = model.init_params(cfg, 0, device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    dense = engine.ServingEngine(cfg, m, max_len=64).generate(prompts, 16).tokens
    for extra in (dict(kv_prefetch=False), {}, dict(async_prefetch=True)):
        ops.reset_launch_counts()
        eng = engine.ServingEngine(cfg, m, max_len=64, kv_compress=True, kv_offload=True,
                                   block_tokens=8, budget_blocks=8, **extra)
        assert np.array_equal(eng.generate(prompts, 16).tokens, dense), extra
        st, made = eng.kv_store.stats, ops.launch_counts()
        assert st.evictions > 0 and st.restores > 0
        assert made["lz_fused_mono"] == st.eviction_dispatches
        assert made["lz_decode_mono"] == st.restore_dispatches
    blocks = [torch.randn(8, 16, 16, generator=torch.Generator().manual_seed(i)).to(
        torch.bfloat16) for i in range(3)]
    blocks[1][4:] = blocks[1][:4]
    card, cpu = kvcache.KVBlockStore(), kvcache.KVBlockStore(device="cpu")
    card.evict_many([(i, b.to(cuda)) for i, b in enumerate(blocks)])
    cpu.evict_many(list(enumerate(blocks)))
    for i, b in enumerate(blocks):
        assert bytes(card._store[i][2]) == bytes(cpu._store[i][2])
        assert np.array_equal(card.restore(i), b.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.gpu
@pytest.mark.parametrize("lossy_eb", [None, 1e-3], ids=["lossless", "lossy"])
@pytest.mark.parametrize("ratio_cap", [1.0, 2.0])
def test_compress_leaf_card_bytes_equal_cpu_bytes(cuda, ratio_cap, lossy_eb, monkeypatch):
    """The gradient wire on the card equals the CPU's bit for bit (run-heavy,
    noise and sparse leaves, several slabs), and so do the decodes."""
    from repro_torch.optim import grad_compress as gc

    monkeypatch.setattr(gc, "SLAB_SYMBOLS", 2048)
    cfg = core.LZSSConfig(symbol_size=2, window=32, chunk_symbols=512)
    rng = np.random.default_rng(1)
    sparse = np.zeros(8192, np.float32)
    sparse[::64] = 0.5
    for g in (np.repeat(rng.normal(size=512) * 0.1, 16).astype(np.float32),
              rng.normal(size=8192).astype(np.float32), sparse):
        x = torch.from_numpy(g)
        ops.reset_launch_counts()
        on_card = gc.compress_leaf(x.to(cuda), cfg, ratio_cap, lossy_eb)
        made = ops.launch_counts()
        on_cpu = gc.compress_leaf(x, cfg, ratio_cap, lossy_eb)
        for k in ("payload", "used_lz", "scale"):
            assert torch.equal(on_card[k].cpu(), on_cpu[k]), k
        assert made["lz_fused_mono"] == (4 if lossy_eb else 1)
        back = gc.decompress_leaf(on_card, g.shape, cfg, ratio_cap, lossy_eb)
        want = gc.decompress_leaf(on_cpu, g.shape, cfg, ratio_cap, lossy_eb)
        assert torch.equal(back.cpu().view(torch.int32), want.view(torch.int32))
    big = np.tile(sparse, 16)  # over MIN_COMPRESS_SIZE: compressed
    stack = torch.from_numpy(np.stack([big, big * 0.5]))
    kw = dict(ratio_cap=ratio_cap, lossy_eb=lossy_eb)
    out = gc.pod_exchange_compressed({"w": stack.to(cuda)}, (cuda, cuda), **kw)["w"]
    want = gc.pod_exchange_compressed({"w": stack}, ("cpu", "cpu"), **kw)["w"]
    assert out.device.type == "cuda" and torch.equal(out.cpu().view(torch.int32),
                                                     want.view(torch.int32))


def _ckpt_leaves(tree):
    from repro_torch.checkpoint import manager as ckpt

    names, leaves, _ = ckpt._leaf_paths(tree)
    return names, [ckpt._leaf_array(x) for x in leaves]


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.gpu
@pytest.mark.parametrize("async_writes", [False, True], ids=["sync", "async"])
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path, async_writes, monkeypatch):
    """The reduced llama3.2-1b's train state on the card (moments made
    non-zero): a save launches the one-launch compressor once a group, a
    restore the one-launch decoder once a geometry group; the restore is
    bit-exact and lies on the card; the step directory equals the one the
    CPU path writes for the same state, byte for byte."""
    import filecmp

    from repro_torch import configs
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps

    cfg = configs.reduced_config(configs.get_config("llama3.2-1b"))
    state = steps.init_train_state(cfg, TrainConfig(), 0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    for part in ("m", "v"):
        state["opt"][part] = {n: torch.randn(v.shape, generator=g, device=cuda) * 1e-3
                              for n, v in state["opt"][part].items()}
    calls = {"compress_many": 0, "decompress_many": 0}
    for name in calls:
        real = getattr(ckpt.lzss, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ckpt.lzss, name, counted)
    mgr = ckpt.CheckpointManager(str(tmp_path / "card"), async_writes=async_writes, device=cuda)
    ops.reset_launch_counts()
    mgr.save(state, 2)
    made = {k: v for k, v in ops.launch_counts().items() if v}
    mgr.wait_until_finished()
    assert calls["compress_many"] > 1 and made == {"lz_fused_mono": calls["compress_many"]}
    ops.reset_launch_counts()
    back, step = mgr.restore_latest(steps.abstract_train_state(cfg, None), shardings=cuda)
    made = {k: v for k, v in ops.launch_counts().items() if v}
    assert step == 2 and made == {"lz_decode_mono": calls["decompress_many"]}
    names, want = _ckpt_leaves(state)
    _, got = _ckpt_leaves(back)
    for name, a, b in zip(names, want, got):
        assert b.device.type == "cuda" and torch.equal(_bits(a), _bits(b)), name
    cpu_state = {"params": back["params"].to("cpu"),
                 "opt": {p: {n: v.cpu() for n, v in back["opt"][p].items()} for p in ("m", "v")},
                 "step": back["step"].cpu()}
    ckpt.CheckpointManager(str(tmp_path / "cpu"), device="cpu").save(cpu_state, 2)
    left, right = tmp_path / "card" / "step_00000002", tmp_path / "cpu" / "step_00000002"
    files = sorted(p.name for p in left.iterdir())
    assert files == sorted(p.name for p in right.iterdir())
    assert filecmp.cmpfiles(left, right, files, shallow=False)[0] == files


@pytest.mark.gpu
def test_reference_step_restores_onto_the_card(cuda):
    """A step directory written by the reference package's manager
    (tests/golden_ckpt) restores onto the card through the one-launch
    decoder, bit for bit."""
    import _ckpt_golden as golden

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.sharding.rules import Placement

    mgr = CheckpointManager(golden.DIRECTORY, device=cuda)
    ops.reset_launch_counts()
    got, step = mgr.restore(golden.torch_tree(), golden.STEP, shardings=Placement(cuda, ()))
    assert step == golden.STEP and ops.launch_counts()["lz_decode_mono"] >= 1
    names, want = _ckpt_leaves(golden.torch_tree())
    _, have = _ckpt_leaves(got)
    for name, a, b in zip(names, want, have):
        assert b.device.type == "cuda" and torch.equal(_bits(a).to(cuda), _bits(b)), name


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b", "mamba2-2.7b"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_meta_trace_counts_the_cards_program(cuda, arch, kind):
    """The dry run's count on meta equals the same step's on card tensors
    (reduced configs): the trace is the card's program."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import roofline, steps
    from repro_torch.models import model

    cfg = configs.reduced_config(configs.get_config(arch))
    shape = ShapeConfig("x", 128, 4, kind)
    batch = model.make_batch(cfg, shape, seed=1, device=cuda)
    if kind == "prefill":
        _, meta = roofline.count(steps.prefill_step, model.abstract_params(cfg),
                                 model.input_specs(cfg, shape), cfg=cfg)
        _, real = roofline.count(steps.prefill_step, model.init_params(cfg, 0, device=cuda),
                                 batch, cfg=cfg)
    else:
        tc = TrainConfig()
        _, meta = roofline.count(steps.train_step, steps.abstract_train_state(cfg, tc),
                                 model.input_specs(cfg, shape), cfg=cfg, traincfg=tc)
        _, real = roofline.count(steps.train_step, steps.init_train_state(cfg, tc, 0, device=cuda),
                                 batch, cfg=cfg, traincfg=tc)
    assert real == meta


@pytest.mark.gpu
def test_twins_on_the_card(cuda, tmp_path):
    """fig_lossy's and kv_paging's checks hold on the card at small sizes,
    with the kernels launched."""
    from repro_torch.benchmarks import fig_lossy, kv_paging, table1_ratio

    ops.reset_launch_counts()
    rec = fig_lossy.run(nbytes=1 << 20, sweep_nbytes=1 << 16, inner="deflate-full",
                        out_json=str(tmp_path / "l.json"))
    assert all(e["bound_ok"] for e in rec["ebs"].values()) and rec["platform"] == "cuda"
    kv = kv_paging.paging_sweep(batch=2, max_len=32, new_tokens=16, out_json=str(tmp_path / "k.json"))
    assert all(e["exact"] for e in kv["budgets"])
    rows = table1_ratio.run(nbytes=1 << 16, chunks=(2048,), windows=(128,), symbols=(2,))
    cpu = table1_ratio.run(nbytes=1 << 16, chunks=(2048,), windows=(128,), symbols=(2,),
                           device="cpu")
    assert {k: v[1] for k, v in rows.items()} == {k: v[1] for k, v in cpu.items()}
    made = ops.launch_counts()
    assert all(made[k] for k in ("lz_fused_mono", "lz_decode_mono", "lz_decode",
                                 "byte_histogram", "huffman_gap_decode", "bitshuffle",
                                 "bitunshuffle"))
