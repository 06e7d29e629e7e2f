"""The port's multi-device batch layer against the reference, on the CPU.

``repro_torch.sharding`` splits the B dimension of the batched entry points
over a mesh of devices; here the meshes are one to three CPU devices, which
exercise the padding, the split and the gather.  Every row's container
must equal the unsharded dispatch's and the reference package's ``xla``
``compress_many`` container, and decode to the input: exact equality.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import lzss as jlzss
from repro.core import pipeline as jpipe
from repro.sharding import batch as jbatch
from repro_torch import core as tcore
from repro_torch import sharding as tsharding
from repro_torch.core import pipeline as tpipe
from repro_torch.sharding import batch as tbatch

from _torch_threads import _one_thread  # noqa: F401

CPU = "cpu"
MESHES = {"none": None, "1": (CPU,), "2": (CPU,) * 2, "3": (CPU,) * 3}
CFG = dict(symbol_size=2, window=32, chunk_symbols=64)


def _items(b: int):
    """B ragged buffers (the batch's chunk count is the longest's)."""
    rng = np.random.default_rng(b)
    out = []
    for i in range(b):
        n = 400 + 97 * i
        x = np.repeat(rng.integers(0, 5, n), rng.integers(1, 6, n))[:n].astype(np.uint8)
        x[: n // 4] = rng.integers(0, 256, n // 4)
        out.append(x)
    return out


@functools.lru_cache(maxsize=None)
def _reference(b: int):
    return jlzss.compress_many(_items(b), jpipe.LZSSConfig(**CFG))


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_containers_equal_unsharded_and_reference(mesh, b):
    items = _items(b)
    plain = tcore.compress_many(items, tcore.LZSSConfig(**CFG), device=CPU)
    got = tcore.compress_many(
        items, tcore.LZSSConfig(**CFG, backend="sharded", mesh=MESHES[mesh]), device=CPU)
    ref = _reference(b)
    assert np.array_equal(got.data, plain.data)
    assert np.array_equal(got.data, np.asarray(ref.data))
    assert list(got.total_bytes) == list(plain.total_bytes) == list(ref.total_bytes)
    outs = tcore.decompress_many(got, device=CPU, mesh=MESHES[mesh])
    assert len(outs) == b
    assert all(np.array_equal(o, x) for o, x in zip(outs, items))
    outs = tcore.decompress_many(got, decoder="sharded", device=CPU)
    assert all(np.array_equal(o, x) for o, x in zip(outs, items))


@pytest.mark.parametrize("backend", ["deflate-full", "lossy-fz"])
@pytest.mark.parametrize("mesh", ["2", "3"])
def test_container_formats_with_a_mesh(backend, mesh):
    extra = dict(lossy_eb=1e-3) if backend == "lossy-fz" else {}
    s = 4 if backend == "lossy-fz" else 2
    rng = np.random.default_rng(9)
    items = [np.cumsum(rng.normal(size=300 + 50 * i)).astype(np.float32) for i in range(4)]
    base = dict(symbol_size=s, window=32, chunk_symbols=64, backend=backend, **extra)
    plain = tcore.compress_many(items, tcore.LZSSConfig(**base), device=CPU)
    got = tcore.compress_many(items, tcore.LZSSConfig(**base, mesh=MESHES[mesh]), device=CPU)
    ref = jlzss.compress_many(items, jpipe.LZSSConfig(**base))
    assert np.array_equal(got.data, plain.data)
    assert np.array_equal(got.data, np.asarray(ref.data))
    outs = tcore.decompress_many(got, device=CPU, mesh=MESHES[mesh])
    want = tcore.decompress_many(plain, device=CPU)
    assert all(np.array_equal(o, w) for o, w in zip(outs, want))
    if backend == "deflate-full":
        assert all(np.array_equal(o, x.view(np.uint8)) for o, x in zip(outs, items))


def test_sharded_decode_of_reference_containers():
    items = _items(4)
    ref = _reference(4)
    blobs = [np.asarray(ref.data)[i, : int(ref.total_bytes[i])] for i in range(4)]
    outs = tcore.decompress_many(blobs, device=CPU, mesh=MESHES["3"], batch_axis="data")
    assert all(np.array_equal(o, x) for o, x in zip(outs, items))


def test_runner_pads_splits_and_gathers():
    items = _items(5)
    cfg = tcore.LZSSConfig(**CFG)
    nc = -(-max(x.size for x in items) // (2 * 64))
    sym = torch.stack([tpipe.pack_symbols(torch.from_numpy(
        np.pad(x, (0, nc * 128 - x.size))), 2).reshape(nc, 64) for x in items])
    runner = tsharding.ShardedBatchRunner(MESHES["3"])
    assert runner.n_shards == 3 and runner.axes == ("data",) and runner._padded_rows(5) == 6
    blobs, totals = runner.compress_many(sym, cfg, [x.size for x in items])
    want_blobs, want_totals = tpipe.compress_many_chunks(sym, cfg, [x.size for x in items])
    assert torch.equal(blobs, want_blobs) and totals == want_totals
    nt = torch.stack([torch.from_numpy(tcore.format.parse_tables(
        blobs[i].numpy(), tcore.format.parse_header(blobs[i].numpy()))[0]) for i in range(5)])
    ps = torch.stack([torch.from_numpy(tcore.format.parse_tables(
        blobs[i].numpy(), tcore.format.parse_header(blobs[i].numpy()))[1]) for i in range(5)])
    got = runner.decompress_many(blobs, nt, ps, symbol_size=2, chunk_symbols=64, n_chunks=nc)
    assert torch.equal(got, sym)
    none = tsharding.ShardedBatchRunner(None)
    assert none.n_shards == 1 and none.axes is None


@pytest.mark.parametrize("shards,rows,want", [
    (None, 3, [None] * 3), (1, 3, [0] * 3), (2, 3, [0, 0, 1]), (3, 5, [0, 0, 1, 1, 2]),
    (3, 2, [0, 1]),
])
def test_map_rows_splits_like_the_batched_cores(shards, rows, want):
    """Container rows go to the same contiguous shards as the batched
    cores' rows, unpadded and in order; without a mesh, to the caller's
    device."""
    mesh = None if shards is None else [torch.device("cpu", i) for i in range(shards)]
    runner = tsharding.ShardedBatchRunner(mesh)
    got = runner.map_rows(lambda r, d: (r, d), list(range(rows)), torch.device("cpu"))
    assert [r for r, _ in got] == list(range(rows))
    assert [d.index for _, d in got] == want


def test_pad_rows_adds_zero_rows():
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    padded = tbatch._pad_rows(x, 4)
    assert padded.shape == (4, 3) and torch.equal(padded[:2], x) and not padded[2:].any()
    assert tbatch._pad_rows(x, 2) is x
    assert tbatch._pad_rows([5, 6], 3) == [5, 6, 0]


@pytest.mark.parametrize("mesh", ["1", "2", "3"])
@pytest.mark.parametrize("rows", [1, 4, 5])
def test_shard_vmap_maps_rows(mesh, rows):
    x = torch.arange(rows * 3, dtype=torch.int64).reshape(rows, 3)
    y = torch.arange(rows, dtype=torch.int64)

    def fn(a, b):
        return a * 2 + b, a.sum()

    got = tsharding.shard_vmap(fn, MESHES[mesh], "data")(x, y)
    assert torch.equal(got[0], x * 2 + y[:, None]) and torch.equal(got[1], x.sum(1))


def test_unsharded_strips_the_mesh():
    cfg = tcore.LZSSConfig(backend="sharded", decoder="sharded", mesh=MESHES["2"])
    inner = tsharding.unsharded(cfg)
    assert (inner.backend, inner.decoder, inner.mesh, inner.batch_axis) == (
        "auto", "auto", None, None)
    plain = tcore.LZSSConfig()
    assert tsharding.unsharded(plain) is plain
    entropy = tcore.LZSSConfig(backend="deflate-full", mesh=MESHES["2"])
    assert tsharding.unsharded(entropy).backend == "deflate-full"
    assert tsharding.unsharded(entropy).mesh is None


def test_mesh_devices_and_batch_axes():
    assert tsharding.mesh_devices("cpu") == (torch.device("cpu"),)
    assert tsharding.mesh_devices([torch.device("cpu"), "cpu"]) == (torch.device("cpu"),) * 2
    assert tcore.LZSSConfig(backend="sharded", mesh=["cpu"]).mesh == (torch.device("cpu"),)
    assert tsharding.batch_axes(MESHES["2"]) == ("data",)
    assert tsharding.normalize_batch_axes(MESHES["2"]) == ("data",)
    assert tsharding.normalize_batch_axes(MESHES["2"], ["data"]) == ("data",)
    for bad in ((), ("meta",), 3):
        with pytest.raises(ValueError):
            tsharding.mesh_devices(bad)


@pytest.fixture
def jmesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


@pytest.mark.parametrize("kw", [
    dict(batch_axis="data"),
    dict(mesh=True, backend="xla"),
    dict(mesh=True, backend="fused", decoder="fused"),
    dict(mesh=True, backend="sharded", batch_axis="pod"),
    dict(mesh=True, backend="deflate-full", batch_axis=("data", "model")),
])
def test_config_mesh_errors_mirror_reference(kw, jmesh):
    def build(pkg, mesh):
        fields = dict(kw)
        if fields.pop("mesh", None):
            fields["mesh"] = mesh
        if pkg is tpipe and fields.get("backend") == "xla":
            fields["backend"] = "auto"
        return pkg.LZSSConfig(**fields)

    with pytest.raises(ValueError) as je:
        build(jpipe, jmesh)
    with pytest.raises(ValueError) as te:
        build(tpipe, MESHES["2"])
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    dict(batch_axis="data"),
    dict(mesh=True, decoder="fused"),
])
def test_decompress_many_mesh_errors_mirror_reference(kw, jmesh):
    blob = jlzss.compress_many(_items(2), jpipe.LZSSConfig(**CFG))
    fields = dict(kw)
    mesh = fields.pop("mesh", None)
    with pytest.raises(ValueError) as je:
        jlzss.decompress_many(blob, mesh=jmesh if mesh else None, **fields)
    blobs = [np.asarray(blob.data)[i, : int(blob.total_bytes[i])] for i in range(2)]
    with pytest.raises(ValueError) as te:
        tcore.decompress_many(blobs, device=CPU, mesh=MESHES["2"] if mesh else None, **fields)
    assert str(te.value) == str(je.value)


def test_reference_runner_names_the_same_surface():
    for name in ("unsharded", "normalize_batch_axes", "shard_vmap", "_pad_rows",
                 "ShardedBatchRunner"):
        assert hasattr(jbatch, name) and hasattr(tbatch, name)
    for attr in ("n_shards", "compress_many", "decompress_many"):
        assert hasattr(tbatch.ShardedBatchRunner, attr)
