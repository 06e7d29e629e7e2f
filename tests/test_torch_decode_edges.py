"""The plain decoders against the reference, on the decoders' edges.

The CUDA decode chain (``csrc/decode_chunk.cuh``) and the CUDA gap-array
Huffman decoder (``csrc/lz_entropy.cu``) are held on the card to their
plain versions on the inputs of ``repro_torch/data/decode_edges.py``
(tests/test_torch_gpu.py, chip_smoke.py).  Here those plain versions are
held to the reference package on the same inputs:

  * ``lz_decode_plain`` to ``repro.core.decode.decode_parallel`` and
    ``lz_decode_mono_plain`` to the reference's ``xla-parallel`` decoder,
    on containers of literal-only chunks, the deepest copy chain, a partial
    last tile of tokens and mixed runs, at C=8 with S in {1, 2, 4} and at
    larger C;
  * ``huffman_gap_decode_plain`` to the reference's ``_decode_scan`` on a
    code with 15-bit codewords, the stored escape, a one-symbol section and
    partial last sub-blocks, each stream ending at its blob's last byte;
  * a plain model of the CUDA gap decoder's 10-bit table with its
    range-test fallback (``table_decode_plain`` here) to the range test, on
    all 2^15 windows of each edge code.

Everything is integer: the tolerance is exact equality.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode as jdecode
from repro.core import entropy as jent
from repro.core import pipeline as jpipe
from repro_torch.core import deflate as tdeflate, format as tfmt
from repro_torch.data import decode_edges
from repro_torch.kernels import lz_decode, lz_decode_mono, lz_entropy
from repro_torch.kernels.lz_entropy import MAX_CODE_LEN, N_SYMBOLS

from _torch_threads import _one_thread  # noqa: F401

_GAP_SRC = (pathlib.Path(__file__).parents[1] / "src/repro_torch/csrc/lz_entropy.cu").read_text()
# Prefix bits of the CUDA gap decoder's table, and the stream bytes its
# block stages a round (kStageWords: 64 sub-blocks of the stored escape
# and 1 KB), read from the kernel's source
TABLE_BITS = int(re.search(r"constexpr int kLutBits = (\d+);", _GAP_SRC).group(1))
GAP_THREADS = int(re.search(r"constexpr int kGapThreads = (\d+);", _GAP_SRC).group(1))
STAGE_BYTES = GAP_THREADS * decode_edges.SUB + 1024

# (S, C): chunks of one tile's eighth at every symbol size, two 256-token
# tiles and a partial one, and the main path's C at S=1
GEOMETRIES = [(1, 8), (2, 8), (4, 8), (2, 520), (4, 520), (1, 2048)]


def _container(kind, s, c, nc=2):
    sym, blob, nt, ps = decode_edges.lz_edge_container(kind, nc, c, s)
    return torch.from_numpy(sym), blob, nt, ps


def _sections(blob, nt, ps, s, c):
    nt, ps = torch.from_numpy(nt), torch.from_numpy(ps).to(torch.int64)
    fs = (nt.to(torch.int64) + 7) // 8
    sec = tfmt.HEADER_BYTES + 8 * nt.numel()
    b = torch.from_numpy(blob)
    flags = tdeflate.gather_section(b, sec, fs, torch.cumsum(fs, 0) - fs, c // 8)
    pay = tdeflate.gather_section(b, sec + int(fs.sum()), ps, torch.cumsum(ps, 0) - ps, c * s)
    return flags, pay, nt


@pytest.mark.parametrize("kind", decode_edges.LZ_KINDS)
@pytest.mark.parametrize("s,c", GEOMETRIES)
def test_lz_decode_plain_equals_reference_on_edges(kind, s, c):
    sym, blob, nt, ps = _container(kind, s, c)
    flags, pay, nt_t = _sections(blob, nt, ps, s, c)
    got = lz_decode.lz_decode_plain(flags, pay, nt_t, symbol_size=s)
    args = [jnp.asarray(x.numpy().astype(np.int32)) for x in (flags, pay, nt_t)]
    assert np.array_equal(got.numpy(), np.asarray(jdecode.decode_parallel(*args, symbol_size=s)))
    assert np.array_equal(got.numpy(), sym.numpy())


@pytest.mark.parametrize("kind", decode_edges.LZ_KINDS)
@pytest.mark.parametrize("s,c", GEOMETRIES)
def test_lz_decode_mono_plain_equals_reference_on_edges(kind, s, c):
    sym, blob, nt, ps = _container(kind, s, c)
    got = lz_decode_mono.lz_decode_mono_plain(
        torch.from_numpy(blob)[None], torch.from_numpy(nt)[None], torch.from_numpy(ps)[None],
        symbol_size=s, chunk_symbols=c)[0]
    xla = jpipe.decompress_chunks(jnp.asarray(blob), jnp.asarray(nt), jnp.asarray(ps),
                                  symbol_size=s, chunk_symbols=c, n_chunks=nt.size,
                                  decoder="xla-parallel")
    assert np.array_equal(got.numpy(), np.asarray(xla))
    assert np.array_equal(got.numpy(), sym.numpy())


def test_lz_edges_reach_what_they_name():
    """Literal-only chunks hold C tokens; the chain is one literal and then
    offset-1 copies of 255 symbols; the partial tile's token count is not a
    multiple of 256."""
    s, c = 2, 2048
    _, _, nt, _ = _container("literals", s, c)
    assert (nt == c).all()
    sym, blob, nt, ps = _container("chain", s, c)
    tfmt.validate_container(blob)
    flags, pay, _ = _sections(blob, nt, ps, s, c)
    assert (nt == 1 + -(-(c - 1) // 255)).all()
    assert (flags[:, 0] == 0xFE).all() and (pay[:, s] == 255).all() and (pay[:, s + 1] == 1).all()
    assert (sym == sym[:, :1]).all()
    _, _, nt, _ = _container("partial-tile", s, c)
    assert (nt % 256 != 0).all()


@pytest.mark.parametrize("kind", decode_edges.GAP_KINDS)
def test_gap_decode_plain_equals_reference_scan_on_edges(kind):
    inp = decode_edges.gap_edge_inputs(kind)
    sec, blob = inp["section"], inp["blob"]
    args = [inp[k] for k in ("blob", "wstarts", "rems", "first", "count", "base", "order")]
    got = lz_entropy.huffman_gap_decode_plain(*args, sub=decode_edges.SUB)
    assert np.array_equal(got.reshape(-1)[: sec.size].numpy(), sec)
    # the reference reads its blob's last byte again past the end, the port
    # zeros: three zero bytes after the stream give both the same bytes on
    # every lane, the partial last sub-block's tail included
    jblob = jnp.asarray(np.concatenate([blob.numpy(), np.zeros(3, np.uint8)]), jnp.int32)
    jtabs = jent.canonical_tables_jax(jnp.asarray(inp["lengths"], jnp.int32))
    for k in ("first", "count", "base", "order"):
        assert np.array_equal(np.asarray(jtabs[k]), inp[k].numpy())
    gaps = (inp["wstarts"] - 3) * 8 + inp["rems"]
    want = jent._decode_scan(jblob, 3, jnp.asarray(gaps.numpy(), jnp.int32), jtabs,
                             sub=decode_edges.SUB)
    assert np.array_equal(got.numpy(), np.asarray(want))


def range_test_plain(win, first, count, base, order):
    """(length, symbol) of each 15-bit window ``win`` by the reference's
    range test: the first length l with ``first[l] <= win >> (15 - l) <
    first[l] + count[l]``, else length 1 (the argmax over an all-false row)."""
    win = win.to(torch.int64)
    ls = torch.arange(1, MAX_CODE_LEN + 1, device=win.device, dtype=torch.int64)
    first, count, base = (t.to(torch.int64) for t in (first, count, base))
    cand = win[:, None] >> (MAX_CODE_LEN - ls)[None, :]
    ok = (cand >= first[1:][None, :]) & (cand - first[1:][None, :] < count[1:][None, :])
    sel = torch.argmax(ok.to(torch.int32), dim=1)
    lsel = sel + 1
    sidx = base[lsel] + cand.gather(1, sel[:, None])[:, 0] - first[lsel]
    return lsel, order.to(torch.int64)[sidx.clamp(0, N_SYMBOLS - 1)]


def decode_table_plain(first, count, base, order, bits: int = TABLE_BITS):
    """The CUDA gap decoder's table: for each ``bits``-bit prefix p,
    ``(l << 8) | symbol`` for the first length l <= bits whose code range
    holds ``p >> (bits - l)``, else 0."""
    p = torch.arange(1 << bits, dtype=torch.int64, device=first.device)
    ls = torch.arange(1, bits + 1, dtype=torch.int64, device=first.device)
    first, count, base = (t.to(torch.int64) for t in (first, count, base))
    cand = p[:, None] >> (bits - ls)[None, :]
    ok = (cand >= first[1 : bits + 1][None, :]) & (cand - first[1 : bits + 1][None, :]
                                                    < count[1 : bits + 1][None, :])
    sel = torch.argmax(ok.to(torch.int32), dim=1)
    lsel = sel + 1
    sidx = base[lsel] + cand.gather(1, sel[:, None])[:, 0] - first[lsel]
    sym = order.to(torch.int64)[sidx.clamp(0, N_SYMBOLS - 1)]
    return torch.where(ok.any(1), (lsel << 8) | sym, 0)


def table_decode_plain(win, first, count, base, order, table, bits: int = TABLE_BITS):
    """(length, symbol) of each 15-bit window as the CUDA gap decoder takes
    them: the table entry of its top ``bits`` bits, else the range test over
    lengths ``bits + 1 .. 15`` with the reference's "no hit -> length 1"."""
    win = win.to(torch.int64)
    e = table.to(torch.int64)[win >> (MAX_CODE_LEN - bits)]
    first, count, base = (t.to(torch.int64) for t in (first, count, base))
    ln = torch.ones_like(win)
    sidx = base[1] + (win >> (MAX_CODE_LEN - 1)) - first[1]
    hit = torch.zeros_like(win, dtype=torch.bool)
    for l in range(bits + 1, MAX_CODE_LEN + 1):
        d = (win >> (MAX_CODE_LEN - l)) - first[l]
        now = ~hit & (d >= 0) & (d < count[l])
        ln = torch.where(now, l, ln)
        sidx = torch.where(now, base[l] + d, sidx)
        hit |= now
    slow = order.to(torch.int64)[sidx.clamp(0, N_SYMBOLS - 1)]
    return torch.where(e > 0, e >> 8, ln), torch.where(e > 0, e & 255, slow)


@pytest.mark.parametrize("kind", decode_edges.GAP_KINDS)
def test_decode_table_equals_range_test_on_every_window(kind):
    """Every 15-bit window decodes to the same length and symbol through the
    table and its fallback as through the range test, and the range test's
    symbols are the reference scan's."""
    inp = decode_edges.gap_edge_inputs(kind)
    tabs = [inp[k] for k in ("first", "count", "base", "order")]
    win = torch.arange(1 << MAX_CODE_LEN)
    table = decode_table_plain(*tabs)
    assert table.shape == (1 << TABLE_BITS,)
    got = table_decode_plain(win, *tabs, table)
    want = range_test_plain(win, *tabs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # one codeword a sub-block: each window's 15 bits as a 3-byte stream
    stream = np.stack([(win.numpy() >> 7) & 0xFF, (win.numpy() << 1) & 0xFF,
                       np.zeros(win.numel(), np.int64)], 1).reshape(-1)
    jtabs = jent.canonical_tables_jax(jnp.asarray(inp["lengths"], jnp.int32))
    syms = jent._decode_scan(jnp.asarray(stream, jnp.int32), 0,
                             jnp.arange(win.numel(), dtype=jnp.int32) * 24, jtabs, sub=1)
    assert np.array_equal(np.asarray(syms)[:, 0], want[1].numpy())


def test_gap_edges_reach_what_they_name():
    """The flag15 code has 15-bit codewords (and codewords the 10-bit table
    does not hold), the escape is 8 bits everywhere, the partial section
    ends inside a sub-block, a block of each stretch section has more stream
    than the CUDA decoder stages a round (its codewords within the table's
    bits for stretch10, past them for stretch12), and every stream ends at
    its blob's last byte."""
    inp = {k: decode_edges.gap_edge_inputs(k) for k in decode_edges.GAP_KINDS}
    l15 = inp["flag15"]["lengths"]
    assert l15.max() == 15 and (l15 == 15).sum() == 2
    assert (inp["escape"]["lengths"] == 8).all()
    assert inp["partial-sub"]["section"].size % decode_edges.SUB != 0
    assert np.unique(inp["one-symbol"]["section"]).size == 1
    table = decode_table_plain(*(inp["flag15"][k] for k in ("first", "count", "base", "order")))
    assert (table == 0).any() and (table > 0).any()
    assert GAP_THREADS == decode_edges.BLOCK_SUBS
    for kind, ncommon, lmax in (("stretch10", 2, TABLE_BITS), ("stretch12", 4, 12)):
        x = inp[kind]
        assert x["lengths"].max() == lmax and (x["lengths"] > 8).sum() == 256 - ncommon
        # stream bits of each block: from its first sub-block's entry point
        # to the next block's (or the stream's end)
        bits = (x["wstarts"] - 3) * 8 + x["rems"]
        ends = torch.cat([bits[GAP_THREADS::GAP_THREADS], torch.tensor([x["nbits"]])])
        block_bytes = (ends - bits[::GAP_THREADS]) // 8
        assert block_bytes.max() > STAGE_BYTES, (kind, block_bytes.max())
    for x in inp.values():
        assert x["blob"].numel() == 3 + (x["nbits"] + 7) // 8
