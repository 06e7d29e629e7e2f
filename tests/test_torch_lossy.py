"""The port's lossy-fz stage (core/bitshuffle.py, core/lossy.py) against the
reference, on the CPU.

Bitshuffle bytes and whole method-2 containers of repro_torch are held to
their repro counterparts on the same seeded numpy inputs (NaN and ±inf
included), and the two packages read each other's containers.  Container
bytes and bitshuffle output are compared exactly; decoded values are held
to the format's guarantee: within eb on every finite element, bit-exact on
non-finite ones, and bit-exact everywhere at eb=0.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitshuffle as jbs
from repro.core import lzss as jlzss
from repro_torch import core as tcore
from repro_torch.core import bitshuffle as tbs
from repro_torch.core import format as tfmt
from repro_torch.core import lossy as tlossy

from _torch_threads import _one_thread  # noqa: F401

CPU = "cpu"
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _cfgs(eb, inner="auto"):
    kw = dict(symbol_size=4, window=64, chunk_symbols=256, backend="lossy-fz",
              lossy_eb=eb, lossy_inner=inner)
    return jlzss.LZSSConfig(**kw), tcore.LZSSConfig(**kw)


def field(n=700, seed=0):
    """A smooth f32 field with NaN, ±inf and a huge value in it.  Sizes in
    (512, 768] share one chunk count (3 at C=256), so one reference compile."""
    rng = np.random.default_rng(seed)
    x = (np.cumsum(rng.normal(size=n)) * 0.03 + np.sin(np.linspace(0, 20, n))).astype(np.float32)
    x[5:9] = [np.nan, np.inf, -np.inf, 3e38]
    x[9] = np.uint32(0x7FC12345).view(np.float32)  # a NaN payload
    return x


def assert_within_bound(x, raw_out, eb):
    y = raw_out.view(np.float32)
    assert y.size == x.size
    fin = np.isfinite(x)
    assert np.array_equal(y[~fin].view(np.uint32), x[~fin].view(np.uint32))
    if eb == 0.0:
        assert np.array_equal(y.view(np.uint32), x.view(np.uint32))
    elif fin.any():
        assert np.abs(y[fin] - x[fin]).max() <= np.float32(eb)


# ------------------------------------------------------------ bitshuffle


def test_bitshuffle_equals_reference():
    units = np.random.default_rng(2).integers(0, 1 << 16, 3 * 512).astype(np.uint16)
    got = tbs.shuffle(torch.from_numpy(units.view(np.int16).copy()))
    want = np.asarray(jbs.shuffle_xla(jnp.asarray(units)))
    assert np.array_equal(got.numpy(), want)
    back = tbs.unshuffle(got)
    assert np.array_equal(back.numpy().view(np.uint16), units)
    assert np.array_equal(back.numpy().view(np.uint16), np.asarray(jbs.unshuffle_xla(jnp.asarray(want))))
    assert np.array_equal(tbs.shuffle(torch.from_numpy(units.view(np.int16).copy()),
                                      impl="plain").numpy(), want)
    with pytest.raises(ValueError, match="multiple"):
        tbs.shuffle(torch.zeros(100, dtype=torch.int16))
    with pytest.raises(ValueError, match="impl"):
        tbs.shuffle(torch.zeros(512, dtype=torch.int16), impl="cuda")


def test_bitshuffle_wire_layout():
    units = torch.zeros(tbs.BLOCK_UNITS, dtype=torch.int16)
    units[8 * 3 + 5] = 1 << 11  # bit 11 of unit 29 -> plane 11, byte 3, bit 5
    out = tbs.shuffle(units)
    expect = torch.zeros(tbs.BLOCK_BYTES, dtype=torch.uint8)
    expect[11 * tbs.PLANE_BYTES + 3] = 1 << 5
    assert torch.equal(out, expect)
    assert tbs.padded_units(1) == 512 and tbs.padded_units(1025) == 1536


# ------------------------------------------------------ whole containers


@pytest.mark.parametrize("inner", ["auto", "deflate-full"])
@pytest.mark.parametrize("eb", [1e-2, 1e-3, 0.0])
def test_containers_byte_identical_and_cross(eb, inner):
    x = field()
    jcfg, tcfg = _cfgs(eb, inner)
    want = jlzss.compress(x, jcfg)
    got = tcore.compress(x, tcfg, device=CPU)
    assert (got.total_bytes, got.orig_bytes) == (want.total_bytes, want.orig_bytes)
    assert np.array_equal(got.data, want.data)
    h = tfmt.parse_header(got.data)
    assert h.method == tfmt.METHOD_LOSSY
    assert h.inner_method == tcore.container_method(inner)
    assert h.lossy_mode == (tfmt.LOSSY_MODE_QUANT if eb else tfmt.LOSSY_MODE_LOSSLESS)
    out = tcore.decompress(want.data, device=CPU)
    assert_within_bound(x, out, eb)
    assert np.array_equal(out, np.asarray(jlzss.decompress(got.data)))


@pytest.mark.parametrize("name,eb", [("f32_s4_w64_c64_lossy", 1e-3),
                                     ("f32_s4_w64_c64_lossy_eb0", 0.0)])
def test_golden_lossy_containers(name, eb):
    raw = np.frombuffer((GOLDEN / f"{name}.input.bin").read_bytes(), np.uint8)
    gold = np.frombuffer((GOLDEN / f"{name}.gplz").read_bytes(), np.uint8)
    cfg = tcore.LZSSConfig(symbol_size=4, window=64, chunk_symbols=64, backend="lossy-fz",
                           lossy_eb=eb)
    assert np.array_equal(tcore.compress(raw, cfg, device=CPU).data, gold)
    assert_within_bound(raw.view(np.float32), tcore.decompress(gold, device=CPU), eb)


@pytest.mark.parametrize("case", ["all-outliers", "denormals"])
def test_outlier_edge_cases_equal_reference(case):
    rng = np.random.default_rng(5)
    if case == "all-outliers":  # every delta saturates the u16 code range
        x = (rng.normal(size=600) * 1e9).astype(np.float32)
    else:
        x = np.full(600, 1e-42, np.float32)
        x[::7] = -4e-44
    jcfg, tcfg = _cfgs(1e-3)
    got = tcore.compress(x, tcfg, device=CPU)
    assert np.array_equal(got.data, jlzss.compress(x, jcfg).data)
    out = tcore.decompress(got.data, device=CPU)
    assert_within_bound(x, out, 1e-3)
    if case == "all-outliers":
        assert np.array_equal(out.view(np.float32), x)  # outliers are exact
        assert tfmt.parse_header(got.data).n_outliers >= x.size


def test_bound_when_eb_exceeds_the_data_range():
    x = np.random.default_rng(6).uniform(-0.4, 0.4, 512).astype(np.float32)
    _, tcfg = _cfgs(1.0)
    res = tcore.compress(x, tcfg, device=CPU)
    assert_within_bound(x, tcore.decompress(res.data, device=CPU), 1.0)


def test_plain_impl_equals_default_path():
    x = field(600, seed=4)
    _, tcfg = _cfgs(1e-3, "deflate-full")
    sym = torch.from_numpy(np.pad(x, (0, 168))).view(torch.int32).reshape(3, 256)
    buf, total = tcore.compress_chunks(sym, tcfg, x.nbytes)
    pbuf, ptotal = tlossy.compress_lossy(sym, tcfg, x.nbytes, impl="plain")
    assert total == ptotal and torch.equal(buf, pbuf)
    h = tfmt.parse_header(buf[:total].numpy())
    assert torch.equal(tlossy.decode_blob_lossy(buf[:total], h, impl="plain"),
                       tlossy.decode_blob_lossy(buf[:total], h))
    assert tlossy.eb_to_f32(1e-3) == float(np.float32(1e-3))


def test_compress_many_equals_reference():
    # one chunk count for all rows: each row is then the single container
    items = [field(n, seed=n) for n in (700, 513, 768)]
    jcfg, tcfg = _cfgs(1e-3)
    got = tcore.compress_many(items, tcfg, device=CPU)
    for i, x in enumerate(items):
        want = jlzss.compress(x, jcfg)
        assert np.array_equal(got[i].data, want.data)
        assert not got.data[i, want.total_bytes:].any()
    outs = tcore.decompress_many(got, device=CPU)
    for x, out in zip(items, outs):
        assert_within_bound(x, out, 1e-3)
    for i, out in enumerate(outs):  # the single-container decode compiled above
        assert np.array_equal(np.asarray(jlzss.decompress(got[i].data)), out)


# -------------------------------------------------- routing and guards


@pytest.mark.parametrize("kw", [
    dict(symbol_size=4, backend="lossy-fz"),
    dict(symbol_size=4, backend="lossy-fz", lossy_eb=-1.0),
    dict(symbol_size=4, backend="lossy-fz", lossy_eb=float("inf")),
    dict(symbol_size=4, backend="lossy-fz", lossy_eb=np.float32(1e-3)),
    dict(symbol_size=2, backend="lossy-fz", lossy_eb=1e-3),
    dict(symbol_size=4, backend="deflate-full", lossy_eb=1e-3),
    dict(symbol_size=4, backend="lossy-fz", lossy_eb=1e-3, lossy_inner="lossy-fz"),
    dict(symbol_size=4, decoder="lossy-fz"),
])
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as je:
        jlzss.LZSSConfig(**kw)
    with pytest.raises(ValueError) as te:
        tcore.LZSSConfig(**kw)
    assert str(te.value) == str(je.value)


def test_config_pins_the_lossy_decoder_and_crosses_from_reference():
    jcfg, tcfg = _cfgs(1e-3, "deflate-full")
    assert tcfg.decoder == jcfg.decoder == "lossy-fz"
    assert tcfg.lossy_eb == 1e-3 and tcore.container_method("lossy-fz") == tfmt.METHOD_LOSSY
    for inner, want in (("xla", "auto"), ("fused-mono", "fused-mono"),
                        ("deflate-full", "deflate-full")):
        j = jlzss.LZSSConfig(symbol_size=4, backend="lossy-fz", lossy_eb=0.0, lossy_inner=inner)
        t = tcore.config_from_jax(dataclasses.asdict(j))
        assert (t.backend, t.decoder, t.lossy_eb, t.lossy_inner) == ("lossy-fz", "lossy-fz", 0.0, want)
    t = tcore.config_from_jax(dataclasses.asdict(jlzss.LZSSConfig(backend="deflate-full")))
    assert (t.backend, t.decoder) == ("deflate-full", "deflate-full")


def test_wrong_decoders_raise_as_the_reference():
    x = field()
    lossy = tcore.compress(x, _cfgs(1e-3)[1], device=CPU).data
    other = tcore.compress(x, _cfgs(1e-3, "deflate-full")[1], device=CPU).data
    raw = tcore.compress(x, tcore.LZSSConfig(symbol_size=4, window=64, chunk_symbols=256),
                         device=CPU).data
    ent = tcore.compress(x, tcore.LZSSConfig(symbol_size=4, window=64, chunk_symbols=256,
                                             backend="deflate-full"), device=CPU).data
    cases = [
        (lambda: jlzss.decompress(lossy, decoder="xla-parallel"),
         lambda: tcore.decompress(lossy, decoder="torch-parallel", device=CPU),
         ("xla-parallel", "torch-parallel")),
        (lambda: jlzss.decompress(lossy, decoder="deflate-full"),
         lambda: tcore.decompress(lossy, decoder="deflate-full", device=CPU), None),
        (lambda: jlzss.decompress(raw, decoder="lossy-fz"),
         lambda: tcore.decompress(raw, decoder="lossy-fz", device=CPU), None),
        (lambda: jlzss.decompress(ent, decoder="lossy-fz"),
         lambda: tcore.decompress(ent, decoder="lossy-fz", device=CPU), None),
        (lambda: jlzss.decompress_many([lossy, raw]),
         lambda: tcore.decompress_many([lossy, raw], device=CPU), None),
        (lambda: jlzss.decompress_many([lossy, other]),
         lambda: tcore.decompress_many([lossy, other], device=CPU), None),
        (lambda: jlzss.decompress_many([lossy], decoder="fused"),
         lambda: tcore.decompress_many([lossy], decoder="fused", device=CPU), None),
        (lambda: jlzss.decompress_many([raw], decoder="lossy-fz"),
         lambda: tcore.decompress_many([raw], decoder="lossy-fz", device=CPU), None),
    ]
    for fj, ft, rename in cases:
        with pytest.raises(ValueError) as je:
            fj()
        with pytest.raises(ValueError) as te:
            ft()
        want = str(je.value) if rename is None else str(je.value).replace(*rename)
        assert str(te.value) == want
    with pytest.raises(ValueError, match="no flag/payload"):
        tcore.get_decoder("lossy-fz", CPU).decode(None, None, None, symbol_size=4)


def test_corrupt_lossy_metadata_raises():
    x = field(600, seed=9)
    res = tcore.compress(x, _cfgs(1e-3)[1], device=CPU)
    blob = res.data
    h = tfmt.parse_header(blob)
    bad = blob.copy()
    bad[h.sec_meta + 4] = 7
    with pytest.raises(ValueError, match="lossy mode"):
        tcore.decompress(bad, device=CPU)
    bad = blob.copy()
    bad[h.sec_meta : h.sec_meta + 4] = 0
    with pytest.raises(ValueError, match="error bound"):
        tcore.decompress(bad, device=CPU)
    for cut in (1, 9, blob.size // 2):
        with pytest.raises(ValueError):
            tcore.decompress(blob[:-cut], device=CPU)
    padded = np.concatenate([blob, np.zeros(257, np.uint8)])
    assert_within_bound(x, tcore.decompress(padded, device=CPU), 1e-3)
