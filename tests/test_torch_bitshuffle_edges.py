"""The plain bitshuffle pair against the reference, on the pair's edges.

The CUDA bitshuffle pair (``csrc/lz_bitshuffle.cu``) is held on the card to
its plain versions on the inputs of ``repro_torch/data/bitshuffle_edges.py``
(tests/test_torch_gpu.py, chip_smoke.py).  Here those plain versions are
held to the reference package on the same inputs:

  * ``bitshuffle_plain`` / ``bitunshuffle_plain`` to the reference's
    ``shuffle_xla`` / ``unshuffle_xla`` on every pattern at every block
    count (ragged tiles included), and round trips;
  * on two small edges, also to the interpret-mode Pallas kernels;
  * the one-hot map (8,192 blocks) to the wire layout's rule, which
    ``tests/test_lossy.py::test_bitshuffle_wire_layout`` pins with one bit;
  * a numpy model of the CUDA kernels' lane arithmetic (the byte gathers and
    the three delta swaps of the 8x8 bit transpose, with the constants read
    from the source) to the plain versions;
  * ``out=`` of the shuffle (``ops.bitshuffle``, ``core.bitshuffle.shuffle``):
    the prefix written, the tail untouched.

Everything is integer: the tolerance is exact equality.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitshuffle as jbs
from repro.kernels import lz_bitshuffle as jlz_bitshuffle
from repro_torch.core import bitshuffle as tbs
from repro_torch.data import bitshuffle_edges as edges
from repro_torch.kernels import lz_bitshuffle, ops

from _torch_threads import _one_thread  # noqa: F401

_SRC = (pathlib.Path(__file__).parents[1] / "src/repro_torch/csrc/lz_bitshuffle.cu").read_text()
CASES = [(p, n) for p in edges.PATTERNS for n in edges.BLOCK_COUNTS]


def _t(units):
    return torch.from_numpy(units.view(np.int16).copy())


def _plain_pair(units):
    shuffled = lz_bitshuffle.bitshuffle_plain(_t(units))
    return shuffled, lz_bitshuffle.bitunshuffle_plain(shuffled)


@pytest.mark.parametrize("pattern,nblocks", CASES)
def test_plain_pair_equals_reference_on_edges(pattern, nblocks):
    units = edges.edge_units(pattern, nblocks, seed=nblocks)
    shuffled, back = _plain_pair(units)
    want = np.asarray(jbs.shuffle_xla(jnp.asarray(units)))
    assert np.array_equal(shuffled.numpy(), want)
    assert np.array_equal(back.numpy().view(np.uint16), np.asarray(jbs.unshuffle_xla(jnp.asarray(want))))
    assert np.array_equal(back.numpy().view(np.uint16), units)


@pytest.mark.parametrize("pattern,nblocks", [("alternating", 3), ("sign", edges.TILE_BLOCKS + 1)])
def test_plain_pair_equals_pallas_on_small_edges(pattern, nblocks):
    units = edges.edge_units(pattern, nblocks)
    shuffled, back = _plain_pair(units)
    pal = jlz_bitshuffle.bitshuffle_pallas(jnp.asarray(units), interpret=True)
    assert np.array_equal(shuffled.numpy(), np.asarray(pal))
    unpal = jlz_bitshuffle.bitunshuffle_pallas(pal, interpret=True)
    assert np.array_equal(back.numpy().view(np.uint16), np.asarray(unpal))


def test_one_hot_map_follows_the_wire_layout():
    """Block 16u + b (only bit b of unit u) shuffles to bit u % 8 of byte
    u // 8 of plane b, every (unit, bit) of a block once; checked in slices
    of 1,024 blocks (blocks are independent)."""
    units, expected = edges.one_hot_units(), edges.one_hot_expected()
    # test_bitshuffle_wire_layout's bit: bit 11 of unit 29 -> plane 11, byte 3, bit 5
    k = 16 * 29 + 11
    assert units[k * 512 + 29] == 1 << 11 and np.count_nonzero(units[k * 512 : (k + 1) * 512]) == 1
    assert expected[k * 1024 + 11 * 64 + 3] == 1 << 5
    assert np.count_nonzero(expected[k * 1024 : (k + 1) * 1024]) == 1
    step = 1024
    for lo in range(0, edges.ONE_HOT_BLOCKS, step):
        u = units[lo * 512 : (lo + step) * 512]
        shuffled, back = _plain_pair(u)
        assert np.array_equal(shuffled.numpy(), expected[lo * 1024 : (lo + step) * 1024])
        assert np.array_equal(shuffled.numpy(), np.asarray(jbs.shuffle_xla(jnp.asarray(u))))
        assert np.array_equal(back.numpy().view(np.uint16), u)


def test_edges_reach_what_they_name():
    """The block counts end the last tile one short, full and one past; the
    patterns are what they say; the tile is the kernel's."""
    assert int(re.search(r"constexpr int kTile = (\d+);", _SRC).group(1)) == edges.TILE_BLOCKS
    assert {n % edges.TILE_BLOCKS for n in edges.BLOCK_COUNTS} >= {edges.TILE_BLOCKS - 1, 0, 1}
    assert edges.BLOCK_COUNTS[-1] > 256 * edges.TILE_BLOCKS
    assert set(edges.edge_units("sign", 1).tolist()) == {0x8000}
    assert edges.edge_units("alternating", 1)[:2].tolist() == [0xAAAA, 0x5555]
    assert len(set(edges.edge_units("random", 2).tolist())) > 900


# ------------------------------------------- a model of the CUDA lane arithmetic

def _byte_perm(a, b, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of b:a."""
    x = a.astype(np.uint64) | (b.astype(np.uint64) << np.uint64(32))
    r = np.zeros(a.shape, np.uint32)
    for i in range(4):
        byte = (x >> np.uint64(8 * ((sel >> (4 * i)) & 7))) & np.uint64(0xFF)
        r |= byte.astype(np.uint32) << np.uint32(8 * i)
    return r


def _transpose8(lo, hi, masks):
    """csrc/lz_bitshuffle.cu's transpose8: three delta swaps of hi:lo."""
    m7, m14, m4 = (np.uint32(m) for m in masks)
    lo, hi = lo.copy(), hi.copy()
    for x in (lo, hi):
        t = (x ^ (x >> np.uint32(7))) & m7
        x ^= t ^ (t << np.uint32(7))
    for x in (lo, hi):
        t = (x ^ (x >> np.uint32(14))) & m14
        x ^= t ^ (t << np.uint32(14))
    t = (hi ^ (lo >> np.uint32(4))) & m4
    return lo ^ (t << np.uint32(4)), hi ^ t


def _source_constants():
    masks = [int(m, 16) for m in re.findall(r"\) & (0x[0-9A-F]{8})u;", _SRC)]
    assert masks[0] == masks[1] and masks[2] == masks[3] and len(masks) == 5
    sels = re.findall(r"__byte_perm\([^()]*, (0x[0-9a-f]{4})\)", _SRC)
    assert len(sels) == 8
    return (masks[0], masks[2], masks[4]), [int(s, 16) for s in sels]


def _shuffle_model(units, masks, sels):
    """A thread's slot (units 8j..8j+7) -> byte j of the 16 planes."""
    w = units.view(np.uint32).reshape(-1, 4)
    x, y, z, v = (w[:, i] for i in range(4))
    l0, l1 = _transpose8(_byte_perm(x, y, sels[0]), _byte_perm(z, v, sels[1]), masks)
    h0, h1 = _transpose8(_byte_perm(x, y, sels[2]), _byte_perm(z, v, sels[3]), masks)
    planes = np.stack([l0, l1, h0, h1], 1).view(np.uint8).reshape(-1, 64, 16)
    return planes.transpose(0, 2, 1).reshape(-1)


def _unshuffle_model(shuffled, masks, sels):
    """Byte j of the 16 planes -> a thread's slot (units 8j..8j+7)."""
    p = shuffled.reshape(-1, 16, 64).transpose(0, 2, 1).reshape(-1, 16).copy().view(np.uint32)
    l0, l1 = _transpose8(p[:, 0], p[:, 1], masks)
    h0, h1 = _transpose8(p[:, 2], p[:, 3], masks)
    out = np.stack([_byte_perm(l0, h0, sels[4]), _byte_perm(l0, h0, sels[5]),
                    _byte_perm(l1, h1, sels[6]), _byte_perm(l1, h1, sels[7])], 1)
    return out.reshape(-1).view(np.uint16)


@pytest.mark.parametrize("pattern", edges.PATTERNS)
def test_lane_model_equals_plain(pattern):
    masks, sels = _source_constants()
    units = edges.edge_units(pattern, edges.TILE_BLOCKS + 1, seed=7)
    shuffled, _ = _plain_pair(units)
    assert np.array_equal(_shuffle_model(units, masks, sels), shuffled.numpy())
    assert np.array_equal(_unshuffle_model(shuffled.numpy(), masks, sels), units)


def test_lane_model_on_the_one_hot_map():
    masks, sels = _source_constants()
    units, expected = edges.one_hot_units(), edges.one_hot_expected()
    assert np.array_equal(_shuffle_model(units, masks, sels), expected)
    assert np.array_equal(_unshuffle_model(expected, masks, sels), units)


# ------------------------------------------------------------------- out=

@pytest.mark.parametrize("via", ["ops", "core", "core-plain"])
def test_out_writes_the_prefix(via):
    units = _t(edges.edge_units("random", 3, seed=1))
    want = lz_bitshuffle.bitshuffle_plain(units)
    buf = torch.zeros(want.numel() + 1000, dtype=torch.uint8)
    if via == "ops":
        got = ops.bitshuffle(units, buf)
    else:
        got = tbs.shuffle(units, impl="plain" if via == "core-plain" else None, out=buf)
    assert torch.equal(got, want) and got.data_ptr() == buf.data_ptr()
    assert not buf[want.numel() :].any()


def test_out_is_checked():
    units = _t(edges.edge_units("ones", 1))
    for bad in (torch.zeros(1023, dtype=torch.uint8), torch.zeros(1024, dtype=torch.int16),
                torch.zeros(2048, dtype=torch.uint8)[::2]):
        with pytest.raises(ValueError, match="out="):
            ops.bitshuffle(units, bad)
    back = lz_bitshuffle.bitunshuffle_plain(torch.zeros(1024, dtype=torch.uint8))
    with pytest.raises(ValueError, match="out="):
        lz_bitshuffle.write_into(torch.zeros(512, dtype=torch.uint8), back, "bitunshuffle")
