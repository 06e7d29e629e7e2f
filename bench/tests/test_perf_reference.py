"""The benchmark's plain decoder and guarantees: against the repository's
golden containers, against small containers of the program on the CPU,
and against damaged containers."""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from _perf_common import ROOT
from bench.gen import hurricane2d
from bench.reference import abs_error_bound, gplz, lossless

GOLDEN = sorted((ROOT / "tests" / "golden").glob("*.gplz"))


def _inputs(path: pathlib.Path) -> np.ndarray:
    return np.fromfile(str(path).replace(".gplz", ".input.bin"), np.uint8)


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_containers_decode(path):
    blob = np.fromfile(path, np.uint8)
    out = gplz.decode(blob).numpy()
    x = _inputs(path)
    if "lossy" not in path.stem or path.stem.endswith("eb0"):
        np.testing.assert_array_equal(out, x)
    else:  # quant mode: the program's own decode of the same bytes
        from repro_torch.core import lzss

        np.testing.assert_array_equal(out, lzss.decompress(blob, device="cpu"))


def _field(form, seed=2**40 + 11, rows=48, cols=96):
    spec = dict(rows=rows, cols=cols, fields=1, form=form, pool_seed=2026, quant_rel_eb=1e-3,
                lorenzo_ndim=2)
    return hurricane2d.make(spec, seed, "cpu")[0]


CODECS = {
    "raw": ("quant_codes", dict(symbol_size=2, window=128, chunk_symbols=2048)),
    "raw-s4-w32": ("f32", dict(symbol_size=4, window=32, chunk_symbols=1024)),
    "deflate-full": ("quant_codes", dict(symbol_size=2, window=128, chunk_symbols=2048,
                                         backend="deflate-full")),
    "lossy-fz-deflate": ("f32", dict(symbol_size=4, window=128, chunk_symbols=2048,
                                     backend="lossy-fz", lossy_inner="deflate-full")),
    "lossy-fz-raw": ("f32", dict(symbol_size=4, window=128, chunk_symbols=2048,
                                 backend="lossy-fz", lossy_inner="auto")),
}


@pytest.mark.parametrize("name", sorted(CODECS))
def test_program_containers_decode_as_the_program_decodes_them(name):
    from repro_torch.core import lzss

    form, codec = CODECS[name]
    field = _field(form)
    if codec.get("backend") == "lossy-fz":
        codec = dict(codec, lossy_eb=abs_error_bound.bound(field, {"rel_to_range": 1e-4}))
    blob = lzss.compress(field, lzss.LZSSConfig(**codec), device="cpu").data
    out = gplz.decode(blob)
    assert torch.equal(out, torch.from_numpy(lzss.decompress(blob, device="cpu")))
    if codec.get("backend") == "lossy-fz":
        got = abs_error_bound.compare(field, out, {"rel_to_range": 1e-4})
        assert got["off_grid"] == 0 and got["max_err_over_eb"] <= 1.0
    else:
        assert lossless.compare(field, out, {}) == {"mismatched_bytes": 0}


def _program_blob(name="raw"):
    from repro_torch.core import lzss

    form, codec = CODECS[name]
    field = _field(form)
    if codec.get("backend") == "lossy-fz":
        codec = dict(codec, lossy_eb=abs_error_bound.bound(field, {"rel_to_range": 1e-4}))
    return field, lzss.compress(field, lzss.LZSSConfig(**codec), device="cpu").data


@pytest.mark.parametrize("cut", [1, 7, 1000])
def test_a_truncated_container_is_refused(cut):
    _, blob = _program_blob()
    with pytest.raises(gplz.ContainerError):
        gplz.decode(blob[:-cut])
    with pytest.raises(gplz.ContainerError):
        gplz.decode(np.concatenate([blob, np.zeros(cut, np.uint8)]))


@pytest.mark.parametrize("name", ["raw", "deflate-full", "lossy-fz-deflate"])
def test_a_damaged_byte_is_refused_or_decodes_wrong(name):
    field, blob = _program_blob(name)
    rng = np.random.default_rng(3)
    spec = {"rel_to_range": 1e-4}
    guarantee = abs_error_bound if "lossy" in name else lossless
    for pos in rng.integers(200, blob.size, 8):
        bad = blob.copy()
        bad[pos] ^= 0x5A
        try:
            out = gplz.decode(bad)
        except gplz.ContainerError:
            continue
        got = guarantee.compare(field, out, spec)
        assert any(v > guarantee.LIMITS[k] for k, v in got.items()), (pos, got)


def test_lossless_compare_counts_bytes_and_length():
    a = torch.arange(100, dtype=torch.uint8)
    b = a.clone()
    b[[3, 50]] += 1
    assert lossless.compare(a, b, {}) == {"mismatched_bytes": 2}
    assert lossless.compare(a, a[:90], {}) == {"mismatched_bytes": 10}


def test_error_bound_compare_on_hand_values():
    x = torch.tensor([0.0, 1.0, -2.5, 10.0], dtype=torch.float32)
    spec = {"rel_to_range": 0.01}  # eb = 0.125, 2 eb = 0.25: these are on the grid
    exact = abs_error_bound.compare(x.view(torch.uint8), x.view(torch.uint8), spec)
    assert exact == {"max_err_over_eb": 0.0, "off_grid": 0}
    y = x.clone()
    y[1] = 1.1  # within the bound but on no grid point and not x
    got = abs_error_bound.compare(x.view(torch.uint8), y.view(torch.uint8), spec)
    assert got["off_grid"] == 1 and 0.79 < got["max_err_over_eb"] < 0.81
    y[2] = -2.0  # a grid point 0.5 away: past the bound
    got = abs_error_bound.compare(x.view(torch.uint8), y.view(torch.uint8), spec)
    assert got["max_err_over_eb"] == pytest.approx(4.0)


def test_the_controls_break_their_guarantees():
    codes = torch.stack([_field("quant_codes")])
    ctl = lossless.control(codes, {}, 2)
    assert lossless.compare(codes[0], ctl[0], {})["mismatched_bytes"] > 0
    f = torch.stack([_field("f32")])
    spec = {"rel_to_range": 1e-4}
    ctl = abs_error_bound.control(f, spec, 4)
    assert abs_error_bound.compare(f[0], ctl[0], spec)["max_err_over_eb"] > 1.0
