"""The plain window walk against the reference, on the walk's edges.

The CUDA kernels that walk the window (``csrc/kernel1.cuh``: a warp's 32
positions per ballot, runs extended word by word) are held on the card to
their plain versions, ``lz_match_plain`` and ``lz_kernel1_plain``, on the
inputs of ``repro_torch/data/walk_edges.py`` (tests/test_torch_gpu.py).
Here those plain versions are held to the reference package's
``core/match.py:find_matches`` and ``kernels/ref.py:lz_kernel1`` on the same
inputs at small C, so the card's oracle is pinned on exactly these edges.
Everything is integer: the tolerance is exact equality.

The last test holds the shared-memory fit: every chunk size accepted
before the warp walk is accepted still.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import match as jmatch
from repro.kernels import ref as jref
from repro_torch.core import autotune
from repro_torch.core.encode import min_match_length
from repro_torch.data import walk_edges
from repro_torch.kernels import lz_match

from _torch_threads import _one_thread  # noqa: F401

# (S, W, C): C=520 is two 256-position tiles and a partial 32-position word;
# C=40 and C=8 are chunks of one word or less; W=1 is the shortest window
GEOMETRIES = [(1, 1, 520), (2, 37, 520), (4, 255, 520), (2, 255, 40), (1, 128, 8)]


def _edges(kind, s, w, c):
    return walk_edges.walk_edge_symbols(kind, 2, c, s, w)


@pytest.mark.parametrize("kind", walk_edges.KINDS)
@pytest.mark.parametrize("s,w,c", GEOMETRIES)
def test_match_plain_equals_reference_on_walk_edges(kind, s, w, c):
    x = _edges(kind, s, w, c)
    got = lz_match.lz_match_plain(torch.from_numpy(x), window=w, symbol_size=s)
    want = jmatch.find_matches(jnp.asarray(x), window=w)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", walk_edges.KINDS)
@pytest.mark.parametrize("s,w,c", GEOMETRIES)
def test_kernel1_plain_equals_reference_on_walk_edges(kind, s, w, c):
    x = _edges(kind, s, w, c)
    kw = dict(window=w, min_match=min_match_length(s), symbol_size=s)
    got = lz_match.lz_kernel1_plain(torch.from_numpy(x), **kw)
    want = jref.lz_kernel1(jnp.asarray(x), **kw)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_walk_edges_reach_what_they_name():
    """The inputs do what their names say at W=255: runs reach the 255 cap,
    a match ends at the chunk's last position, lengths tie at several
    offsets, and two-symbol noise differs only in the top bit."""
    c, w = 2048, 255
    for s in (1, 2, 4):
        lengths = {}
        for kind in walk_edges.KINDS:
            x = torch.from_numpy(_edges(kind, s, w, c))
            lengths[kind], _ = lz_match.lz_match_plain(x, window=w, symbol_size=s)
        assert int(lengths["cap"].max()) == 255 and int(lengths["all-equal"].max()) == 255
        assert (lengths["chunk-end"][:, -1] > 0).all()
        ends = torch.arange(c) + lengths["word-cross"][0]
        assert ((ends % 32 > 0) & (ends // 32 > torch.arange(c) // 32)).any()
        assert ((ends // 256) > (torch.arange(c) // 256)).any()
        x = _edges("noise2", s, w, c).view(np.uint32)
        assert np.unique(x ^ x[0, 0]).tolist() in ([0, 1 << (8 * s - 1)], [1 << (8 * s - 1), 0])
    x = _edges("ties", 2, w, c)[0]
    motif = x[5:17]
    starts = [q for q in range(c - 12) if np.array_equal(x[q : q + 12], motif)]
    assert len(starts) >= 4  # the same 12 symbols at several earlier offsets


def _earlier_smem_need(c, s):
    """The kernels' shared-memory need before the warp walk (Kernel I and
    the match-only kernel C*S + 2C, the decoders 4C, Kernel III's flag
    words, the one-launch compressor max(C*S, C + words) + 2C)."""
    words = 4 * -(-c // 32)
    return max(c * s + 2 * c, 4 * c, words, max(c * s, c + words) + 2 * c)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_block_geometry_accepts_every_earlier_geometry(s):
    accepted = [
        c for c in range(8, 70_000, 8)
        if _earlier_smem_need(c, s) + autotune.SMEM_STATIC_BYTES <= autotune.SMEM_LIMIT_BYTES
    ]
    assert accepted[-1] == {1: 57_856, 2: 57_856, 4: 38_568}[s]
    for c in accepted:
        autotune.validate_block_geometry(c, 1, s)
