"""The port's gradient exchange (repro_torch.optim.grad_compress) against the
reference package's, on the CPU.

The same seeded numpy leaves go through both packages.  The wire (payload
bytes, the per-slab used-LZ flags, the scale) must be bit-equal, lossless
and lossy, with one slab and with several (``SLAB_SYMBOLS`` patched in both
modules for the test), and each package must decode the other's wire to
the same f32 bits.  The pod exchange over a mesh of two CPU devices is held
to the per-pod quantize mean of the reference (within 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import format as jfmt
from repro.core.lzss import LZSSConfig as JConfig
from repro.optim import grad_compress as jgc
from repro_torch.core import format as tfmt, lossy, pipeline
from repro_torch.core.pipeline import LZSSConfig as TConfig
from repro_torch.optim import grad_compress as tgc

from _torch_threads import _one_thread  # noqa: F401

GEOM = dict(symbol_size=2, window=32, chunk_symbols=512)
EB = 1e-3


def _leaf(kind):
    """The leaves of tests/test_grad_compress.py: run-heavy, noise, sparse."""
    rng = np.random.default_rng(1)
    if kind == "redundant":
        return np.repeat(rng.normal(size=512) * 0.1, 16).astype(np.float32)
    if kind == "noise":
        return rng.normal(size=8192).astype(np.float32)
    g = np.zeros(8192, np.float32)
    g[::64] = 0.5
    return g


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.fixture(params=["one", "several"])
def slabs(request, monkeypatch):
    """One slab a leaf, or 2048-symbol slabs (4 a leaf), in both packages."""
    if request.param == "several":
        monkeypatch.setattr(jgc, "SLAB_SYMBOLS", 2048)
        monkeypatch.setattr(tgc, "SLAB_SYMBOLS", 2048)
    return request.param


@pytest.mark.parametrize("kind", ["redundant", "noise", "sparse"])
def test_quantize_u16_bit_equal(kind):
    g = _leaf(kind)
    jc, js = jgc.quantize_u16(jnp.asarray(g))
    tc, ts = tgc.quantize_u16(torch.from_numpy(g))
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.asarray(js).tobytes() == ts.numpy().tobytes()
    back = tgc.dequantize_u16(tc, ts).numpy()
    assert np.array_equal(_bits(back), _bits(jgc.dequantize_u16(jc, js)))


@pytest.mark.parametrize("lossy_eb", [None, EB], ids=["lossless", "lossy"])
@pytest.mark.parametrize("ratio_cap", [1.0, 2.0])
@pytest.mark.parametrize("kind", ["redundant", "noise", "sparse"])
def test_wire_bit_equal_and_crosses_both_ways(kind, ratio_cap, lossy_eb, slabs):
    g = _leaf(kind)
    jcfg, tcfg = JConfig(**GEOM), TConfig(**GEOM)
    jw = jgc.compress_leaf(jnp.asarray(g), jcfg, ratio_cap, lossy_eb)
    tw = tgc.compress_leaf(torch.from_numpy(g), tcfg, ratio_cap, lossy_eb)
    n_slabs = 1 if slabs == "one" else 4
    assert tw["used_lz"].shape == (n_slabs,)
    assert np.array_equal(np.asarray(jw["payload"]), tw["payload"].numpy())
    assert np.array_equal(np.asarray(jw["used_lz"]), tw["used_lz"].numpy())
    assert np.asarray(jw["scale"]).tobytes() == tw["scale"].numpy().tobytes()

    want = _bits(jgc.decompress_leaf(jw, g.shape, jcfg, ratio_cap, lossy_eb))
    got = tgc.decompress_leaf(tw, g.shape, tcfg, ratio_cap, lossy_eb)
    assert got.dtype == torch.float32 and np.array_equal(_bits(got), want)
    # the port reads the reference's wire, the reference the port's
    from_ref = {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}
    assert np.array_equal(_bits(tgc.decompress_leaf(from_ref, g.shape, tcfg, ratio_cap,
                                                    lossy_eb)), want)
    from_port = {k: jnp.asarray(v.numpy()) for k, v in tw.items()}
    assert np.array_equal(_bits(jgc.decompress_leaf(from_port, g.shape, jcfg, ratio_cap,
                                                    lossy_eb)), want)


@pytest.mark.parametrize("kind", ["redundant", "noise", "sparse"])
def test_lossy_slabs_within_eb(kind, slabs):
    """A lossy slab that fits the budget decodes within eb of the input; a
    fallback slab within its u16 quantization step."""
    g = _leaf(kind)
    w = tgc.compress_leaf(torch.from_numpy(g), TConfig(**GEOM), 1.0, EB)
    out = tgc.decompress_leaf(w, g.shape, TConfig(**GEOM), 1.0, EB).numpy()
    err = np.abs(out - g).reshape(w["used_lz"].shape[0], -1).max(axis=1)
    used = w["used_lz"].numpy()
    assert np.all(err[used] <= np.float32(EB))
    assert np.all(err[~used] <= float(w["scale"]) * 0.5001)


def test_noise_falls_back_at_the_tight_budget():
    """Pure noise does not fit 1 B/elem: every slab sends its high bytes,
    and the decode stays within 129 quantization steps."""
    g = _leaf("noise")
    w = tgc.compress_leaf(torch.from_numpy(g), TConfig(**GEOM), 2.0)
    assert w["payload"].numel() == g.size and not bool(w["used_lz"].any())
    out = tgc.decompress_leaf(w, g.shape, TConfig(**GEOM), 2.0).numpy()
    assert np.abs(out - g).max() <= float(w["scale"]) * 129


def test_parse_tables_torch_equals_parse_tables_jax():
    g = _leaf("redundant")
    codes, _ = tgc.quantize_u16(torch.from_numpy(g))
    cfg = TConfig(**GEOM)
    blobs, totals = pipeline.compress_many_chunks(codes.reshape(2, -1, 512), cfg)
    nc = codes.numel() // 2 // 512
    nt, ps = tfmt.parse_tables_torch(blobs, nc)
    for r in range(2):
        jt, jp = jfmt.parse_tables_jax(jnp.asarray(blobs[r].numpy().astype(np.int32)), nc)
        assert np.array_equal(nt[r].numpy(), np.asarray(jt))
        assert np.array_equal(ps[r].numpy(), np.asarray(jp))
        _, ht, hp = tfmt.validate_container(blobs[r, : totals[r]].numpy())
        assert np.array_equal(nt[r].numpy(), ht) and np.array_equal(ps[r].numpy(), hp)


@pytest.mark.parametrize("eb", [EB, 0.0])
@pytest.mark.parametrize("inner", ["auto", "deflate-full"])
def test_lossy_batch_decode_equals_container_decode(eb, inner):
    """decompress_many_chunks(decoder="lossy-fz", method_params=...) over a
    batch equals each container's own decode; without the pin, or with a
    wrong one, it raises."""
    g = np.stack([_leaf("redundant"), _leaf("sparse")])
    cfg = TConfig(symbol_size=4, window=32, chunk_symbols=512, backend="lossy-fz",
                  lossy_eb=eb, lossy_inner=inner)
    bits = torch.from_numpy(g.view(np.int32)).reshape(2, -1, 512)
    blobs, totals = pipeline.compress_many_chunks(bits, cfg)
    nc = bits.shape[1]
    zeros = torch.zeros(2, nc, dtype=torch.int32)
    pin = tgc._lossy_method_params(cfg)
    got = pipeline.decompress_many_chunks(blobs, zeros, zeros, symbol_size=4, chunk_symbols=512,
                                          n_chunks=nc, decoder="lossy-fz", method_params=pin)
    for r in range(2):
        h = tfmt.parse_header(blobs[r, : totals[r]].numpy())
        assert torch.equal(got[r], lossy.decode_blob_lossy(blobs[r, : totals[r]], h))
    kw = dict(symbol_size=4, chunk_symbols=512, n_chunks=nc, decoder="lossy-fz")
    with pytest.raises(ValueError, match="method_params"):
        pipeline.decompress_many_chunks(blobs, zeros, zeros, **kw)
    with pytest.raises(ValueError, match="pinned"):
        pipeline.decompress_many_chunks(blobs, zeros, zeros, method_params=(1 - pin[0], pin[1]),
                                        **kw)


def test_lossy_grad_config_matches_reference():
    for backend in ("auto", "deflate-full", "fused-mono"):
        j = jgc.lossy_grad_config(EB, JConfig(**GEOM, backend=backend))
        t = tgc.lossy_grad_config(EB, TConfig(**GEOM, backend=backend))
        assert (t.symbol_size, t.backend, t.decoder, t.lossy_eb, t.lossy_inner) == (
            j.symbol_size, j.backend, j.decoder, j.lossy_eb, j.lossy_inner)
    assert tgc.MIN_COMPRESS_SIZE == jgc.MIN_COMPRESS_SIZE
    assert (tgc.GRAD_LZ.symbol_size, tgc.GRAD_LZ.window, tgc.GRAD_LZ.chunk_symbols) == (
        jgc.GRAD_LZ.symbol_size, jgc.GRAD_LZ.window, jgc.GRAD_LZ.chunk_symbols)


def _quantize_mean(g):
    """The per-pod quantize mean of tests/test_sharding.py (the reference)."""
    want = 0.0
    for k in range(g.shape[0]):
        codes, scale = jgc.quantize_u16(jnp.asarray(g[k]))
        want = want + np.asarray(jgc.dequantize_u16(codes, scale))
    return want / g.shape[0]


@pytest.mark.parametrize("kind", ["noise", "sparse"])
def test_pod_exchange_equals_per_pod_quantize_mean(kind):
    """A mesh of two CPU devices, one a pod, at the lossless budget."""
    rng = np.random.default_rng(0)
    if kind == "noise":
        g = rng.normal(size=(2, 131072)).astype(np.float32)
    else:
        g = np.zeros((2, 131072), np.float32)
        g[0, ::64], g[1, 3::97] = 0.5, -0.25
    grads = {"w": torch.from_numpy(g), "b": torch.from_numpy(g[:, :512].copy())}
    out = tgc.pod_exchange_compressed(grads, ("cpu", "cpu"), ratio_cap=1.0)
    np.testing.assert_allclose(out["w"].numpy(), _quantize_mean(g), atol=1e-6)
    # a leaf under MIN_COMPRESS_SIZE is averaged as it is
    assert torch.equal(out["b"], torch.from_numpy(g[:, :512].mean(0)))
    plain = tgc.pod_exchange_compressed(grads, ("cpu", "cpu"), compress=False)
    assert torch.equal(plain["w"], torch.from_numpy(g).mean(0))


def test_pod_exchange_keeps_dtype_and_checks_pods():
    rng = np.random.default_rng(2)
    g = torch.from_numpy(np.repeat(rng.normal(size=(2, 8192)), 16, axis=1).astype(np.float32))
    out = tgc.pod_exchange_compressed([g.to(torch.bfloat16)], ("cpu", "cpu"), lossy_eb=EB)
    assert out[0].dtype == torch.bfloat16 and out[0].shape == (131072,)
    assert float((out[0].float() - g.to(torch.bfloat16).float().mean(0)).abs().max()) < 1e-2
    with pytest.raises(ValueError, match="pod rows"):
        tgc.pod_exchange_compressed({"w": g}, ("cpu", "cpu", "cpu"))
