"""Kernel III and the byte histogram: plain versions and kernel models on
their edge inputs.

The CUDA Kernel III (``csrc/lz_scatter.cu``) and byte histogram
(``csrc/lz_entropy.cu``) are held on the card to their plain versions on
the inputs of ``repro_torch/data/scatter_edges.py`` (tests/test_torch_gpu.py,
chip_smoke.py).  Here, on the CPU:

  * Kernel III's plain version against the sections of the reference's
    ``emit_xla`` (its Pallas Kernel III does not run on this jax: ``pl.load``
    is gone), on every edge kind at C in {8, 40, 2,056} and S in {1, 2, 4};
  * a numpy model of the CUDA Kernel III, its constants read from the
    source (the warps of a block, the 128-position group, the staged
    layout's limit): the two passes' token carries, the ballot ranks, the
    four words of a group's pointer bits and their OR into the flag words
    at the carry, the payload at local_off, and the copy-out's head, 16-byte
    body of funnel-shifted words and tail; held to the plain version on
    every edge kind at every geometry of the edges, both layouts included;
  * the histogram's plain version against the reference's XLA histogram,
    its interpret-mode Pallas kernel and ``np.bincount`` on every pattern
    at every (start, length) of ``RANGES``;
  * a numpy model of the CUDA histogram's split (unaligned head, 16-byte
    vectors in grid-stride turns of the source's unroll, the next turn
    loaded before a turn is counted, tail) and of its counting (a vector or
    a word of one value one atomicAdd), held to ``np.bincount``.

Everything is integer: the tolerance is exact equality.
"""

import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import entropy as jent
from repro.core import pipeline as jpipe
from repro.kernels import lz_entropy as jlz_entropy
from repro_torch.core import format as fmt
from repro_torch.data import scatter_edges as edges
from repro_torch.kernels import lz_entropy, lz_scatter

from _torch_threads import _one_thread  # noqa: F401

_CSRC = pathlib.Path(__file__).parents[1] / "src/repro_torch/csrc"
_SCATTER = (_CSRC / "lz_scatter.cu").read_text()
_ENTROPY = (_CSRC / "lz_entropy.cu").read_text()


SMALL = [(c, s) for c, s in edges.GEOMETRIES if c <= 2056]


@functools.lru_cache(maxsize=None)
def _inputs(kind, c, s, rows=2):
    nc = edges.chunks_for(c)
    x = edges.scatter_inputs(kind, rows, nc, c, s, seed=17 * c + 5 * s + edges.KINDS.index(kind))
    fo, po = edges.section_offsets(x["n_tokens"], x["payload_sizes"])
    kw = dict(symbol_size=s, min_match=edges.min_match(s),
              cap=fmt.max_compressed_bytes(nc * c * s, s, c), sec_flags=fmt.HEADER_BYTES + 8 * nc)
    return x, fo, po, kw


def _plain(x, fo, po, kw):
    t = {k: torch.from_numpy(x[k]) for k in ("symbols", "lengths", "offsets", "emitted", "local_off")}
    return lz_scatter.scatter_plain(
        t["symbols"], t["lengths"], t["offsets"], t["emitted"], t["local_off"],
        torch.from_numpy(fo), torch.from_numpy(po), **kw).numpy()


# --------------------------------------------------------------- Kernel III


@pytest.mark.parametrize("kind", edges.KINDS)
@pytest.mark.parametrize("c,s", SMALL)
def test_scatter_plain_equals_reference_emit(kind, c, s):
    x, fo, po, kw = _inputs(kind, c, s)
    blob = _plain(x, fo, po, kw)
    sec = kw["sec_flags"]
    jcfg = jpipe.LZSSConfig(symbol_size=s, window=128, chunk_symbols=c)
    for r in range(blob.shape[0]):
        em, ln = jnp.asarray(x["emitted"][r]), jnp.asarray(x["lengths"][r])
        use = em & (ln >= kw["min_match"])
        k1 = dict(emitted=em, use_match=use, lengths=ln, offsets=jnp.asarray(x["offsets"][r]),
                  local_off=jnp.asarray(x["local_off"][r]), n_tokens=jnp.asarray(x["n_tokens"][r]),
                  sizes=jnp.where(em, jnp.where(use, 2, s), 0),
                  payload_sizes=jnp.asarray(x["payload_sizes"][r]))
        want, total = jpipe.emit_xla(jnp.asarray(x["symbols"][r]), k1, jcfg)
        want = np.asarray(want)
        assert int(total) == sec + int(po[r, -1] + x["payload_sizes"][r, -1])
        assert np.array_equal(blob[r, sec:], want[sec:])  # header/tables: host work
        assert not blob[r, :sec].any()


def _popc(x):
    return np.array([bin(int(v)).count("1") for v in np.asarray(x).reshape(-1)]).reshape(np.shape(x))


def _store_span_model(dst_addr, src, n):
    """csrc/lz_scatter.cu's store_span: the bytes it writes at dst_addr +
    [0, n) from the shared words ``src`` (bytes, padded by a word): the head
    to a 16-byte boundary and the tail byte by byte, the body in 16-byte
    stores of words funnel-shifted by the head's residue mod 4."""
    out = np.zeros(n, np.uint8)
    head = min(n, (16 - dst_addr % 16) % 16)
    nbody = (n - head) >> 4
    tail = head + 16 * nbody
    out[:head] = src[:head]
    out[tail:n] = src[tail:n]
    words = np.frombuffer(src[: len(src) // 4 * 4].tobytes(), np.uint32).astype(np.uint64)
    sh = np.uint64(8 * (head & 3))
    for i in range(nbody):
        q = words[(head >> 2) + 4 * i : (head >> 2) + 4 * i + 5]
        body = [((q[k + 1] << np.uint64(32) | q[k]) >> sh) & np.uint64(0xFFFFFFFF)
                for k in range(4)]
        assert (dst_addr + head + 16 * i) % 16 == 0
        out[head + 16 * i : head + 16 * i + 16] = np.array(body, np.uint32).view(np.uint8)
    return out


def _scatter_model(x, fo, po, kw, warps, group, stage_bytes):
    """The CUDA Kernel III's arithmetic, chunk by chunk, on blobs whose rows
    start on 16-byte boundaries modulo the row stride (the blob is one
    allocation).  Returns (blob, layouts seen)."""
    s, mm, cap, sec = kw["symbol_size"], kw["min_match"], kw["cap"], kw["sec_flags"]
    rows, nc, c = x["symbols"].shape
    blob = np.zeros((rows, cap), np.uint8)
    staged = 4 * ((c + 31) // 32 + 1) + c * s + 4 <= stage_bytes
    nfw = (c + 31) // 32 + 1
    lanes = np.arange(32)
    lower = (np.uint64(1) << lanes.astype(np.uint64)) - np.uint64(1)
    ngroups = -(-c // group)
    bounds = [w * ngroups // warps for w in range(warps + 1)]
    for r in range(rows):
        for k in range(nc):
            e, ln = x["emitted"][r, k], x["lengths"][r, k]
            sym, off, loc = x["symbols"][r, k], x["offsets"][r, k], x["local_off"][r, k]
            counts = [int(e[bounds[w] * group : bounds[w + 1] * group].sum()) for w in range(warps)]
            ntok = sum(counts)
            flags = np.zeros(nfw, np.uint64)
            stage = np.zeros(c * s + 8, np.uint8)
            pay_end = 0
            for w in range(warps):
                carry = sum(counts[:w])
                for g in range(bounds[w], bounds[w + 1]):
                    p = g * group + 4 * lanes
                    valid = p < c
                    rank = np.zeros(32, np.int64)
                    group_tokens = 0
                    kinds = np.zeros(32, np.uint64)
                    mine = np.zeros(32, np.int64)
                    for j in range(4):
                        pj = np.where(valid, p + j, 0)
                        ej = valid & e[pj]
                        ballot = int((ej.astype(np.uint64) << lanes.astype(np.uint64)).sum())
                        rank += _popc(np.uint64(ballot) & lower)
                        group_tokens += bin(ballot).count("1")
                        match = ej & (ln[pj] >= mm)
                        kinds |= match.astype(np.uint64) << mine.astype(np.uint64)
                        for lane in np.flatnonzero(ej):
                            q = pj[lane]
                            v = ([ln[q] & 0xFF, off[q] & 0xFF] if match[lane] else
                                 [(int(sym[q]) >> (8 * b)) & 0xFF for b in range(s)])
                            stage[loc[q] : loc[q] + len(v)] = v
                            pay_end = max(pay_end, int(loc[q]) + len(v))
                        mine += ej
                    k0, sh = rank >> 5, (rank & 31).astype(np.uint64)
                    low = (kinds << sh) & np.uint64(0xFFFFFFFF)
                    high = np.where(sh > 0, kinds >> (np.uint64(32) - sh), 0).astype(np.uint64)
                    words = [int(np.bitwise_or.reduce(np.where(k0 == kk, low, 0) |
                                                      np.where(k0 + 1 == kk, high, 0)))
                             for kk in range(4)]
                    for kk, word in enumerate(words):
                        if not word:
                            continue
                        bit = carry + 32 * kk
                        flags[bit >> 5] |= np.uint64((word << (bit & 31)) & 0xFFFFFFFF)
                        if bit & 31 and word >> (32 - (bit & 31)):
                            assert (bit >> 5) + 1 < nfw  # the word of pad at most
                            flags[(bit >> 5) + 1] |= np.uint64(word >> (32 - (bit & 31)))
                    carry += group_tokens
            fbytes = flags.astype(np.uint32).view(np.uint8)
            nfb = (ntok + 7) // 8
            at = sec + int(fo[r, k])
            blob[r, at : at + nfb] = _store_span_model(r * cap + at, fbytes, nfb)
            at = sec + int(po[r, k])
            blob[r, at : at + pay_end] = _store_span_model(r * cap + at, stage, pay_end)
            assert pay_end == x["payload_sizes"][r, k]
    return blob, "staged" if staged else "direct"


def _scatter_constants():
    warps = int(re.search(r"constexpr int kScatterThreads = (\d+);", _SCATTER).group(1)) // 32
    group = int(re.search(r"constexpr int kGroup = (\d+);", _SCATTER).group(1))
    stage = re.search(r"constexpr int kStageBytes = (\d+) \* 1024;", _SCATTER)
    return warps, group, int(stage.group(1)) * 1024


@pytest.mark.parametrize("kind", edges.KINDS)
@pytest.mark.parametrize("c,s", edges.GEOMETRIES)
def test_scatter_model_equals_plain(kind, c, s):
    warps, group, stage = _scatter_constants()
    x, fo, po, kw = _inputs(kind, c, s)
    model, layout = _scatter_model(x, fo, po, kw, warps, group, stage)
    assert np.array_equal(model, _plain(x, fo, po, kw))
    assert layout == ("staged" if edges.staged_bytes(c, s) <= stage else "direct")


def test_scatter_edges_reach_what_they_name():
    """The constants are the source's; the layout edges straddle the staged
    limit at every S; the kinds are what they say; the flag and payload
    starts of the mixed rows fall on every residue mod 16."""
    warps, group, stage = _scatter_constants()
    assert stage == edges.STAGE_BYTES and group == edges.GROUP and warps == 8
    assert "4ll * flag_words(C) + static_cast<long long>(C) * S + 4" in _SCATTER
    for s in (1, 2, 4):
        lo, hi = edges.layout_edge(s)
        assert edges.staged_bytes(lo, s) <= stage < edges.staged_bytes(hi, s) and hi == lo + 8
    assert any(edges.staged_bytes(c, s) > stage for c, s in edges.GEOMETRIES if c == 32768)
    for c, s in edges.GEOMETRIES:
        assert c % 8 == 0
        lit = _inputs("literals", c, s)[0]
        assert (lit["n_tokens"] == c).all() and (lit["payload_sizes"] == c * s).all()
        mat = _inputs("matches", c, s)[0]
        assert (mat["lengths"][mat["emitted"]] >= edges.min_match(s)).all()
        assert (mat["symbols"] == mat["symbols"][..., :1]).all()
        rag = _inputs("ragged", c, s)[0]
        assert (rag["n_tokens"] % 8 != 0).all() and (rag["n_tokens"] % 32 != 0).all()
        for kind in edges.KINDS:  # Kernel I's invariant: a payload fits C * S
            assert (_inputs(kind, c, s)[0]["payload_sizes"] <= c * s).all()
    for c in (8, 40):  # payload sizes are even at S = 2 and 4: residues over all S
        starts = {"flags": set(), "payload": set()}
        for s in (1, 2, 4):
            x, fo, po, kw = _inputs("mixed", c, s)
            base = np.arange(2)[:, None] * kw["cap"] + kw["sec_flags"]
            starts["flags"] |= set(((base + fo) % 16).reshape(-1).tolist())
            starts["payload"] |= set(((base + po) % 16).reshape(-1).tolist())
        assert starts == {"flags": set(range(16)), "payload": set(range(16))}


# ---------------------------------------------------------------- histogram


@pytest.mark.parametrize("pattern", edges.HIST_PATTERNS)
def test_histogram_plain_equals_reference_on_ranges(pattern):
    buf = edges.histogram_bytes(pattern, 64, seed=3)
    jbuf = jnp.asarray(buf, jnp.int32)
    for start, length in edges.RANGES:
        got = lz_entropy.byte_histogram_plain(torch.from_numpy(buf), start, length).numpy()
        assert np.array_equal(got, np.bincount(buf[start : start + length], minlength=256))
        assert np.array_equal(got, np.asarray(jent.byte_histogram(jbuf, start, length, impl="xla")))
        assert np.array_equal(got, np.asarray(
            jlz_entropy.byte_histogram_pallas(jbuf, start, length, interpret=True)))


def _count_vec_model(row, v):
    """csrc/lz_entropy.cu's count_vec: 16 bytes into a warp's row; returns
    the atomicAdds it issues."""
    w = v.view(np.uint32)
    rep = np.uint32(int(w[0] & 0xFF) * 0x01010101)
    if (w == rep).all():
        row[w[0] & 0xFF] += 16
        return 1
    adds = 0
    for x in w:
        if x == np.uint32(int(x & 0xFF) * 0x01010101):
            row[x & 0xFF] += 4
            adds += 1
        else:
            for k in range(4):
                row[(int(x) >> (8 * k)) & 0xFF] += 1
            adds += 4
    return adds


def _hist_model(buf, start, length, threads, unroll, blocks):
    """The CUDA histogram's split of [start, start + length) of a buffer that
    starts on a 16-byte boundary: the bytes up to the first boundary and the
    tail a byte a thread, the 16-byte vectors in grid-stride turns of
    ``unroll`` loads a lane (the next turn loaded before a turn is counted),
    each thread counting into its warp's row.  Returns (counts, how many
    times each byte was counted, atomicAdds issued)."""
    head = min(length, (16 - start % 16) % 16)
    nvec = (length - head) // 16
    nthreads = threads * blocks
    rows = np.zeros((nthreads // 32, 256), np.int64)
    seen = np.zeros(length, np.int64)
    adds = 0
    for tid in range(min(nthreads, max(head, length - head - 16 * nvec))):
        for i in list(range(tid, head, nthreads)) + list(
                range(head + 16 * nvec + tid, length, nthreads)):
            rows[tid // 32, buf[start + i]] += 1
            seen[i] += 1
            adds += 1
    for tid in range(nthreads):
        loaded = [tid + u * nthreads for u in range(unroll)]
        for i0 in range(tid, nvec, unroll * nthreads):
            nxt = [i0 + (unroll + u) * nthreads for u in range(unroll)]
            for u in range(unroll):
                i = loaded[u]
                assert i == i0 + u * nthreads
                if i < nvec:
                    lo = start + head + 16 * i
                    adds += _count_vec_model(rows[tid // 32], buf[lo : lo + 16])
                    seen[head + 16 * i : head + 16 * i + 16] += 1
            loaded = nxt
    return rows.sum(0), seen, adds


@pytest.mark.parametrize("pattern", edges.HIST_PATTERNS)
def test_histogram_model_on_ranges(pattern):
    threads = int(re.search(r"constexpr int kHistThreads = (\d+);", _ENTROPY).group(1))
    unroll = int(re.search(r"constexpr int kHistUnroll = (\d+);", _ENTROPY).group(1))
    buf = edges.histogram_bytes(pattern, 4096, seed=4)
    for start, length in list(edges.RANGES) + [(5, 4000), (16, 4080)]:
        nvec = max(0, length - (16 - start % 16) % 16) // 16
        blocks = max(1, -(-nvec // (unroll * threads)))
        got, seen, _ = _hist_model(buf, start, length, threads, unroll, blocks)
        assert (seen == 1).all()
        assert np.array_equal(got, np.bincount(buf[start : start + length], minlength=256))
    # two blocks, so that turns of the grid stride interleave
    got, seen, _ = _hist_model(buf, 3, 4090, threads, unroll, 2)
    assert (seen == 1).all() and np.array_equal(got, np.bincount(buf[3:4093], minlength=256))


def test_histogram_runs_take_one_add():
    """A 16-byte vector of one value is one atomicAdd, a word of one value
    one; the alternating 0x00 / 0xFF words take 4 adds a vector; random bytes
    16.  A row counter holds at most the bytes its warp read, below 2^31."""
    threads = int(re.search(r"constexpr int kHistThreads = (\d+);", _ENTROPY).group(1))
    unroll = int(re.search(r"constexpr int kHistUnroll = (\d+);", _ENTROPY).group(1))
    n = 16 * 1024
    for pattern, per_vec in (("zeros", 1), ("ones", 1), ("one-value", 1), ("alternating", 4)):
        buf = edges.histogram_bytes(pattern, n + 16)
        _, _, adds = _hist_model(buf, 16, n, threads, unroll, 1)
        assert adds == n // 16 * per_vec
    buf = edges.histogram_bytes("random", n + 16, seed=5)
    _, _, adds = _hist_model(buf, 16, n, threads, unroll, 1)
    assert adds > 15 * n // 16
    assert "__ldcs(v + i)" in _ENTROPY and "unsigned int hist[kHistWarps][256]" in _ENTROPY


def test_histogram_edges_reach_what_they_name():
    assert {length for _, length in edges.RANGES} == {0, 1, 15, 16, 17}
    assert {start % 16 for start, _ in edges.RANGES} == set(range(16))
    assert set(edges.histogram_bytes("ones", 8).tolist()) == {0xFF}
    assert set(edges.histogram_bytes("one-value", 8).tolist()) == {0x7F}
    assert edges.histogram_bytes("alternating", 8).tolist() == [0] * 4 + [0xFF] * 4
    assert len(set(edges.histogram_bytes("random", 4096).tolist())) == 256
    assert edges.BIG_BYTES >= 1000 * 65536
