"""Seeded inputs at the edges of the two decoders.

The LZSS decode chain (``csrc/decode_chunk.cuh``: tokens a thread, a
max-scan fill, pointer doubling to the fixed point) and the gap-array
Huffman decoder (``csrc/lz_entropy.cu``: a staged stream window a lane, a
10-bit table with a range-test fallback) are held to their plain versions
on these, by the tests and ``chip_smoke.py``, and the plain versions to the
reference package.

LZSS containers (``lz_edge_container``) of nc chunks of C symbols of S
bytes, each with its symbols:

  literals      no symbol repeats within 256 positions: every token is a
                literal, C tokens a chunk (the most a chunk holds)
  chain         one symbol everywhere, written as a literal and then
                offset-1 copies of 255 symbols: every position copies the
                one before it, the deepest copy chain (C - 1 links, the most
                doubling rounds).  The compressor never writes it (its
                copies are at most as long as their offset), so the
                container is assembled here; the reference's parallel
                decoder reads it as the symbol repeated
  partial-tile  300 literals, then one run: a token count that is not a
                multiple of 256 (a partial last tile of the block)
  runs          short runs of a few symbols with an incompressible
                stretch: a mix of pointers and literals of every length

Every kind but ``chain`` is compressed by ``core/pipeline`` on the CPU.

Gap-decoder sections (``gap_edge_section``), uint8 bytes:

  flag15       16 byte values with counts 1, 1, 2, 4, ..., 2^14: a code of
               lengths 1..15, two 15-bit codewords (past the table's 10)
  escape       a flat histogram: the stored escape, every length 8
  one-symbol   one byte value
  partial-sub  skewed bytes whose count is not a multiple of 512 (a
               partial last sub-block)
  skewed       skewed bytes in whole sub-blocks
  stretch10    a code of lengths 1, 2 and 9-10, and a 32 KiB stretch of
               only the 10-bit symbols filling the second block of 64
               sub-blocks: its ~40 KB of stream is more than the decoder
               stages a round (64 sub-blocks of the stored escape and
               1 KB), so that block decodes in rounds, from the table
  stretch12    the same with lengths 1-4 and 11-12: the stretch's ~49 KB
               decode in rounds through the range test

``gap_edge_inputs`` codes a section with ``core/entropy`` and puts its
stream behind a few bytes of junk, so that entry points are unaligned and
the stream ends at the blob's last byte.
"""

from __future__ import annotations

import numpy as np
import torch

LZ_KINDS = ("literals", "chain", "partial-tile", "runs")
GAP_KINDS = ("flag15", "escape", "one-symbol", "partial-sub", "skewed", "stretch10", "stretch12")
BLOCK_SUBS = 64  # sub-blocks a block of the CUDA gap decoder (kGapThreads)
SUB = 512  # decoded bytes a gap entry point (format.DEFAULT_SUB_LOG2)


def _chunk(kind: str, c: int, vmax: int, rng, k: int) -> np.ndarray:
    distinct = (np.arange(c, dtype=np.int64) * 7 + k) % 256  # period 256 > any window
    if kind == "literals":
        return distinct * (vmax // 256) + int(rng.integers(0, vmax // 256))
    if kind == "chain":
        return np.full(c, int(rng.integers(0, vmax)), np.int64)
    if kind == "partial-tile":
        x = distinct.copy()
        x[min(300, c // 2) :] = 1000 % vmax
        return x
    if kind == "runs":
        x = np.repeat(rng.integers(0, 5, c), rng.integers(1, 7, c))[:c].astype(np.int64)
        x[: c // 5] = rng.integers(0, vmax, c // 5)
        return x
    raise ValueError(f"unknown decode edge {kind!r}: one of {LZ_KINDS}")


def _edge_symbols(kind: str, nc: int, c: int, symbol_size: int, seed: int = 0) -> np.ndarray:
    """(nc, c) int32 symbols of ``kind`` (see the module docstring); at S=4
    the bit pattern counts and a symbol may be negative."""
    rng = np.random.default_rng([seed, c, symbol_size, LZ_KINDS.index(kind)])
    vmax = 1 << (8 * symbol_size)
    x = np.stack([_chunk(kind, c, vmax, rng, k) for k in range(nc)])
    return x.astype(np.uint32).view(np.int32)


def _chain_container(sym: np.ndarray, s: int):
    """A container of one-symbol chunks written as a literal and offset-1
    copies of up to 255 symbols."""
    from repro_torch.core import format as fmt

    nc, c = sym.shape
    ncopy = -(-(c - 1) // 255)
    ntok = 1 + ncopy
    lens = [min(255, c - 1 - 255 * j) for j in range(ncopy)]
    flags = np.zeros(-(-ntok // 8), np.uint8)
    for t in range(1, ntok):
        flags[t >> 3] |= 1 << (t & 7)
    copies = np.array([[ln, 1] for ln in lens], np.uint8).reshape(-1)
    lit = sym.view(np.uint32)[:, :1].view(np.uint8).reshape(nc, 4)[:, :s]
    pay = np.concatenate([lit, np.broadcast_to(copies, (nc, copies.size))], 1)
    nt = np.full(nc, ntok, np.int32)
    ps = np.full(nc, pay.shape[1], np.int32)
    out = torch.zeros(fmt.HEADER_BYTES + 8 * nc, dtype=torch.uint8)
    fmt.write_header_and_tables(
        out, symbol_size=s, window=255, chunk_symbols=c, n_chunks=nc, orig_bytes=nc * c * s,
        payload_total=int(ps.sum()), flag_total=nc * flags.size, n_tokens=torch.from_numpy(nt),
        payload_sizes=torch.from_numpy(ps))
    blob = np.concatenate([out.numpy(), np.tile(flags, nc), pay.reshape(-1)])
    return blob, nt, ps


def lz_edge_container(kind: str, nc: int, c: int, symbol_size: int, seed: int = 0,
                      device="cpu"):
    """(symbols (nc, c) int32, the container's live bytes (uint8), n_tokens
    (nc,) int32, payload_sizes (nc,) int32) of ``kind``, as numpy arrays;
    ``device`` is where the compressor runs."""
    from repro_torch.core import format as fmt, pipeline as pl

    sym = _edge_symbols(kind, nc, c, symbol_size, seed)
    if kind == "chain":
        return (sym, *_chain_container(sym, symbol_size))
    blob, total = pl.compress_chunks(torch.from_numpy(sym).to(device),
                                     pl.LZSSConfig(symbol_size=symbol_size, chunk_symbols=c))
    blob = blob[:total].cpu().numpy()
    _, nt, ps = fmt.validate_container(blob)
    return sym, blob, nt, ps


def gap_edge_section(kind: str, seed: int = 0) -> np.ndarray:
    """uint8 section bytes of ``kind`` (see the module docstring)."""
    rng = np.random.default_rng([seed, GAP_KINDS.index(kind)])
    if kind == "flag15":
        values = rng.permutation(256)[:16]
        counts = [1] + [1 << i for i in range(15)]
        sec = np.repeat(values, counts)
        return rng.permutation(sec).astype(np.uint8)  # 32,768 bytes: 64 sub-blocks
    if kind == "escape":
        return np.tile(np.arange(256, dtype=np.uint8), 20)[:5000]
    if kind == "one-symbol":
        return np.full(777, 9, np.uint8)
    if kind in ("partial-sub", "skewed"):
        n = 3 * SUB + 77 if kind == "partial-sub" else 8 * SUB
        return np.repeat(rng.integers(0, 40, n), rng.integers(1, 9, n)).astype(np.uint8)[:n]
    if kind in ("stretch10", "stretch12"):
        # k common values with counts r * 2^(k-1), ..., r * 2, r + r/8 take
        # lengths 1..k; the 256 - k rare ones share r and the last 2^-k of
        # the code space, at lengths k + 7 and k + 8
        k, r = (2 if kind == "stretch10" else 4), BLOCK_SUBS * SUB
        vals = rng.permutation(256)
        common = np.repeat(vals[:k], [r << (k - 1 - i) for i in range(k - 1)] + [r + r // 8])
        stretch = vals[k:][np.arange(r) % (256 - k)]
        common, stretch = rng.permutation(common), rng.permutation(stretch)
        return np.concatenate([common[:r], stretch, common[r:]]).astype(np.uint8)
    raise ValueError(f"unknown gap edge {kind!r}: one of {GAP_KINDS}")


def gap_edge_inputs(kind: str, seed: int = 0, lead: int = 3, device="cpu") -> dict:
    """The gap decoder's arguments for one coded section of ``kind``.

    Returns ``section`` (the bytes, numpy), ``lengths`` (the container's code
    lengths), ``nbits``, ``blob`` (``lead`` junk bytes, then the stream up
    to its last live byte, nothing after), ``wstarts`` / ``rems`` (the
    entry points of the live sub-blocks, as blob byte offsets and bit
    remainders) and the canonical tables ``first`` / ``count`` / ``base`` /
    ``order``, all on ``device``.
    """
    from repro_torch.core import entropy

    sec = gap_edge_section(kind, seed)
    n = sec.size
    lengths = entropy.container_code_lengths(np.bincount(sec, minlength=256))
    stream, nbits, gaps = entropy.encode_section(torch.from_numpy(sec), 0, n, lengths, cap=n)
    junk = torch.from_numpy(np.random.default_rng(seed).integers(1, 256, lead).astype(np.uint8))
    blob = torch.cat([junk, stream[: (nbits + 7) // 8]])
    g = gaps[: -(-n // SUB)]
    tabs = entropy.canonical_tables(lengths)
    out = dict(blob=blob, wstarts=lead + (g >> 3), rems=(g & 7).to(torch.int32),
               **{k: tabs[k] for k in ("first", "count", "base", "order")})
    out = {k: v.to(device) for k, v in out.items()}
    return dict(out, section=sec, lengths=lengths, nbits=nbits)
