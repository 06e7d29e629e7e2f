"""repro_torch.core.format against the reference repro.core.format.

The port keeps its own copy of the container reader; these tests hold it to
the reference on the golden corpus (12 current and 7 version-1 blobs), on
truncated and corrupted blobs (the same ValueError text), and hold the
torch header writer to the reference's writer byte for byte.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import format as jfmt
from repro_torch.core import format as tfmt

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
BLOBS = sorted(
    [p.relative_to(GOLDEN).as_posix() for p in GOLDEN.glob("*.gplz")]
    + [p.relative_to(GOLDEN).as_posix() for p in (GOLDEN / "v1").glob("*.gplz")]
)


def _blob(name):
    return np.frombuffer((GOLDEN / name).read_bytes(), np.uint8)


def test_corpus_size():
    assert len(BLOBS) == 19


@pytest.mark.parametrize("name", BLOBS)
def test_golden_blob_parses_as_reference(name):
    blob = _blob(name)
    jh, th = jfmt.parse_header(blob), tfmt.parse_header(blob)
    assert dataclasses.asdict(jh) == dataclasses.asdict(th)
    assert jh.total_bytes == th.total_bytes
    for a, b in zip(jfmt.parse_tables(blob, jh), tfmt.parse_tables(blob, th)):
        assert np.array_equal(a, b)
    jv, tv = jfmt.validate_container(blob), tfmt.validate_container(blob)
    assert dataclasses.asdict(jv[0]) == dataclasses.asdict(tv[0])
    assert np.array_equal(jv[1], tv[1]) and np.array_equal(jv[2], tv[2])


def _mutations():
    """(label, function of a golden blob -> corrupted blob)."""

    def put(offset, value):
        def f(b):
            b = b.copy()
            b[offset] = value
            return b
        return f

    def put_u32(offset, value):
        def f(b):
            b = b.copy()
            b[offset : offset + 4] = np.frombuffer(
                int(value).to_bytes(4, "little"), np.uint8
            )
            return b
        return f

    return {
        "truncated_header": lambda b: b[:20],
        "truncated_body": lambda b: b[:-3],
        "bad_magic": put(0, 0),
        "bad_version": put(4, 3),
        "bad_method": put(40, 7),
        "bad_symbol_size": put(5, 3),
        "zero_window": lambda b: put(7, 0)(put(6, 0)(b)),
        "odd_chunk_symbols": put(8, 65),
        "zero_chunks": put_u32(12, 0),
        "table_over_bound": put_u32(48, 1 << 20),
        "orig_bytes_over_capacity": put_u32(16, 1 << 30),
        "header_total_mismatch": put_u32(24, 1),
        "symbol_size_flip": put(5, 1),
    }


MUTATIONS = _mutations()


@pytest.mark.parametrize("label", sorted(MUTATIONS))
@pytest.mark.parametrize("name", ["i16_s2_w64_c64.gplz", "f32_s4_w255_c128.gplz"])
def test_corrupt_blob_raises_same_error(name, label):
    bad = MUTATIONS[label](_blob(name))
    with pytest.raises(ValueError) as je:
        jfmt.validate_container(bad)
    with pytest.raises(ValueError) as te:
        tfmt.validate_container(bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("c", [8, 64, 2048, 32768])
@pytest.mark.parametrize("n", [0, 1, 1000, 1 << 20])
def test_max_compressed_bytes(n, s, c):
    assert tfmt.max_compressed_bytes(n, s, c) == jfmt.max_compressed_bytes(n, s, c)


@pytest.mark.parametrize("nc,orig", [(1, 0), (3, 777), (5, 123456)])
def test_header_writer_matches_reference(nc, orig):
    rng = np.random.default_rng(nc)
    n_tokens = rng.integers(0, 300, nc).astype(np.int32)
    payload = rng.integers(0, 600, nc).astype(np.int32)
    kw = dict(symbol_size=2, window=200, chunk_symbols=2048, n_chunks=nc,
              orig_bytes=orig, payload_total=int(payload.sum()),
              flag_total=int(((n_tokens + 7) // 8).sum()))
    cap = jfmt.HEADER_BYTES + 8 * nc + 16
    want = jfmt.write_header_and_tables(
        jnp.zeros((cap,), jnp.int32), n_tokens=jnp.asarray(n_tokens),
        payload_sizes=jnp.asarray(payload), **kw,
    )
    got = tfmt.write_header_and_tables(
        torch.zeros(cap, dtype=torch.uint8), n_tokens=torch.from_numpy(n_tokens),
        payload_sizes=torch.from_numpy(payload), **kw,
    )
    assert np.array_equal(np.asarray(want).astype(np.uint8), got.numpy())
    h = tfmt.parse_header(got.numpy())
    assert (h.n_chunks, h.orig_bytes, h.window) == (nc, orig, 200)
