"""Kernel II, the global prefix sums: its plain version and a model of the
CUDA kernel on the edge inputs.

The CUDA Kernel II (``csrc/lz_scatter.cu``, ``global_offsets``) is held on
the card to its plain version on the inputs of
``repro_torch/data/offsets_edges.py`` (tests/test_torch_gpu.py,
chip_smoke.py).  Here, on the CPU:

  * the plain version against the reference's ``deflate.global_offsets``
    on every edge (every kind at every nc and every row count);
  * the plain version against the reference's interpret-mode Pallas Kernel
    II (``lz_global_offsets_pallas``), row by row, its padded outputs cut
    to nc, at every nc up to 4,100;
  * a numpy model of the CUDA kernel's partition, its constants read from
    the source: the frame that starts at the row's 16-byte boundary, tiles
    of up to kTileRounds rounds of every warp, a lane's int4 vector in
    each warp-striped round, the lanes' partial sums, the shuffle scan of
    a round's lane sums and the warp's running carry, the one cross-warp
    scan a tile, the one-tile pass over both arrays against the longer
    row's flag total summed first (each thread's vectors, then the warps')
    and its tiles with a carry for each array, and the payload offsets
    pre-based by the flag total; held to the plain version at every
    residue of the rows' starts on a few edges that take each of its
    paths (the card tests run the kernel itself on every edge);
  * the plain version on views that start 4, 8 and 12 bytes past a 16-byte
    boundary.

Everything is integer: the tolerance is exact equality (sums wrap mod 2^32
in every implementation).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deflate as jdeflate
from repro.kernels import lz_scatter as jlz_scatter
from repro_torch.data import offsets_edges as edges
from repro_torch.kernels import lz_scatter, ops

from _torch_threads import _one_thread  # noqa: F401

_SOURCE = (pathlib.Path(__file__).parents[1] / "src/repro_torch/csrc/lz_scatter.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SOURCE).group(1))


THREADS = _const("kOffsetThreads")
VEC = _const("kVecChunks")
TILE_ROUNDS = _const("kTileRounds")
REDUCE_LOADS = _const("kReduceLoads")
WARPS = THREADS // 32
ROUND = 32 * VEC  # a warp's round
BLOCK_ROUND = WARPS * ROUND  # a round of every warp
TILE = TILE_ROUNDS * BLOCK_ROUND
INTERPRET_NCS = [nc for nc in edges.NCS if nc <= 4100]


def test_model_constants_are_the_source_s():
    for line in ("constexpr int kOffsetWarps = kOffsetThreads / 32;",
                 "constexpr int kRoundChunks = 32 * kVecChunks;",
                 "constexpr int kBlockRound = kOffsetWarps * kRoundChunks;",
                 "constexpr int kTileChunks = kTileRounds * kBlockRound;"):
        assert line in _SOURCE
    assert (THREADS, VEC, TILE) == (1024, 4, 16384)


def _plain(nt, ps):
    return [t.numpy() for t in lz_scatter.global_offsets_plain(torch.from_numpy(nt),
                                                               torch.from_numpy(ps))]


# ------------------------------------------------------- plain vs reference


@pytest.mark.parametrize("nc", edges.NCS)
@pytest.mark.parametrize("kind", edges.KINDS)
def test_plain_equals_reference(kind, nc):
    for rows in edges.ROWS:
        nt, ps = edges.offsets_inputs(kind, rows, nc)
        fo, po, tot = _plain(nt, ps)
        via_ops = ops.lz_global_offsets(torch.from_numpy(nt), torch.from_numpy(ps))
        assert all(np.array_equal(a, b.numpy()) for a, b in zip((fo, po, tot), via_ops))
        for r in range(rows):
            pay_off, pay_tot, flag_off, flag_tot = jdeflate.global_offsets(
                jnp.asarray(ps[r]), (jnp.asarray(nt[r]) + 7) // 8)
            assert np.array_equal(fo[r], np.asarray(flag_off)), (rows, r)
            assert np.array_equal(po[r], np.asarray(pay_off + flag_tot)), (rows, r)
            assert tot[r].tolist() == [int(flag_tot), int(pay_tot)], (rows, r)


@pytest.mark.parametrize("nc", INTERPRET_NCS)
@pytest.mark.parametrize("kind", edges.KINDS)
def test_plain_equals_interpret_pallas(kind, nc):
    for rows in edges.ROWS:
        nt, ps = edges.offsets_inputs(kind, rows, nc)
        fo, po, tot = _plain(nt, ps)
        for r in range(rows):
            jfo, jpo, jft, jpt = jlz_scatter.lz_global_offsets_pallas(
                jnp.asarray(nt[r]), jnp.asarray(ps[r]), interpret=True)
            assert np.array_equal(fo[r], np.asarray(jfo)[:nc]), (rows, r)
            assert np.array_equal(po[r], np.asarray(jpo)[:nc]), (rows, r)
            assert tot[r].tolist() == [int(jft), int(jpt)], (rows, r)


@pytest.mark.parametrize("shift", edges.VIEW_BYTES)
def test_plain_on_misaligned_views(shift):
    for kind, rows, nc in (("random", 3, 1025), ("ragged", 8, 33), ("last", 1, 16385)):
        nt, ps = (torch.from_numpy(a) for a in edges.offsets_inputs(kind, rows, nc))
        want = lz_scatter.global_offsets_plain(nt, ps)
        got = lz_scatter.global_offsets_plain(edges.view_at(nt, shift), edges.view_at(ps, shift))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------ model of the CUDA kernel


def _tile_scan(vals, f0, rr, carry):
    """scan_tile on the frame values ``vals`` of the tile at f0 with rr
    rounds: warp w's round j, lane l, chunk k is frame f0 + (w * rr + j) *
    ROUND + VEC * l + k.  Returns the exclusive sums plus carry, in frame
    order, and the carry past the tile."""
    seg = np.zeros(WARPS * rr * ROUND, np.int64)
    part = vals[f0 : f0 + seg.size]
    seg[: part.size] = part
    x = seg.reshape(WARPS, rr, 32, VEC)
    partial = np.cumsum(x, -1)  # the lane's partial sums
    lane_sum = partial[..., -1]
    incl = np.cumsum(lane_sum, -1)  # the shuffle scan of a round's lane sums
    round_total = incl[..., -1]  # lane 31's, by shuffle
    run = np.cumsum(round_total, 1) - round_total  # the warp's running carry
    out = (run[..., None] + incl - lane_sum)[..., None] + partial - x
    warp_total = round_total.sum(1)
    warp_incl = np.cumsum(warp_total)  # the one cross-warp scan
    out += (carry + warp_incl - warp_total)[:, None, None, None]
    return out.reshape(-1), carry + int(warp_incl[-1])


def _flag_reduction(flag):
    """row_flag_total: thread t sums the vectors at f0 + (u * THREADS + t) *
    VEC for u < REDUCE_LOADS in each batch of THREADS * VEC * REDUCE_LOADS
    frame chunks; the warps' and then the block's sums."""
    batch = THREADS * VEC * REDUCE_LOADS
    frame = np.zeros(-(-flag.size // batch) * batch, np.int64)
    frame[: flag.size] = flag
    per_thread = frame.reshape(-1, REDUCE_LOADS, THREADS, VEC).sum(axis=(0, 1, 3))
    return int(per_thread.reshape(WARPS, 32).sum(1).sum())


def _tile_rounds(length, f0):
    return min(TILE_ROUNDS, -(-(length - f0) // BLOCK_ROUND))


def kernel_model(nt, ps, sh):
    """Kernel II on one row whose n_tokens start ``sh`` int32s past a 16-byte
    boundary -> (flag_off, pay_off, [flag_total, pay_total]) as int32."""
    nc = nt.size
    length = nc + sh
    flag, pay = (np.zeros(length, np.int64) for _ in range(2))
    flag[sh:] = (nt.astype(np.int64) + 7) >> 3  # floor, as the plain version
    pay[sh:] = ps
    fo, po = (np.zeros(length, np.int64) for _ in range(2))
    if length <= TILE:  # one tile, both arrays in the same pass
        rr = _tile_rounds(length, 0)
        f, flag_total = _tile_scan(flag, 0, rr, 0)
        p, pay_total = _tile_scan(pay, 0, rr, 0)
        fo[:], po[:] = f[:length], p[:length] + flag_total
    else:  # the flag total first, then tiles of both arrays with their carries
        flag_total = _flag_reduction(flag)
        flag_carry = pay_total = 0
        for f0 in range(0, length, TILE):
            rr = _tile_rounds(length, f0)
            f, flag_carry = _tile_scan(flag, f0, rr, flag_carry)
            p, pay_total = _tile_scan(pay, f0, rr, pay_total)
            fo[f0 : f0 + f.size] = f[: length - f0]
            po[f0 : f0 + p.size] = p[: length - f0] + flag_total
        assert flag_carry == flag_total
    totals = np.array([flag_total, pay_total], np.int64)
    return fo[sh:].astype(np.int32), po[sh:].astype(np.int32), totals.astype(np.int32)


# one round cut short, a round of every warp, a tile that the frame's shift
# makes two, a last tile of fewer rounds, many tiles at the largest sums
MODEL_CASES = [("ragged", 33), ("random", 1025), ("last", 16384), ("random", 16385),
               ("literals", 32769), ("random", 65541)]


@pytest.mark.parametrize("kind,nc", MODEL_CASES)
def test_kernel_model_equals_plain(kind, nc):
    for rows in edges.ROWS:
        nt, ps = edges.offsets_inputs(kind, rows, nc)
        fo, po, tot = _plain(nt, ps)
        for base in range(4):  # the rows' starting residue in int32s
            for r in range(rows):
                got = kernel_model(nt[r], ps[r], (base + r * nc) % 4)
                assert np.array_equal(got[0], fo[r]), (rows, base, r)
                assert np.array_equal(got[1], po[r]), (rows, base, r)
                assert got[2].tolist() == tot[r].tolist(), (rows, base, r)


def test_edges_reach_what_they_name():
    """The edges hold one-tile and swept rows, tiles cut short, every row
    residue, the largest sums and the flag rounding."""
    lengths = {nc + sh for nc in edges.NCS for sh in range(4)}
    assert any(n <= TILE for n in lengths) and any(n > TILE for n in lengths)
    assert {16384 + sh > TILE for sh in range(4)} == {False, True}  # the shift adds a tile
    assert any(n % BLOCK_ROUND and n > TILE for n in lengths)  # a last tile of fewer rounds
    assert any(n % ROUND and n < BLOCK_ROUND for n in lengths)  # a round cut short
    for nc in edges.NCS:
        if nc % 4:
            assert {(r * nc) % 4 for r in range(8)} == {0, 1, 2, 3}
    nt, _ = edges.offsets_inputs("ragged", 8, 65541)
    assert (nt % 8 != 0).all()
    nt, ps = edges.offsets_inputs("literals", 1, 262144)
    assert int(ps.astype(np.int64).sum()) == 1 << 31  # past int32: wraps everywhere
    nt, ps = edges.offsets_inputs("last", 3, 33)
    assert (nt[:, :-1] == 0).all() and (nt[:, -1] % 8).all() and (ps[:, -1] > 0).all()
    for shift in edges.VIEW_BYTES:
        assert edges.view_at(torch.arange(5, dtype=torch.int32), shift).data_ptr() % 16 == shift
