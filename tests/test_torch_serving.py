"""The port's serving modules (repro_torch.serving) against the reference
package's, on the CPU.

* paging: the allocator, the prefetch queue and the LRU tracker behave step
  for step as the reference's on the same operation sequences;
* KVBlockStore: stored blobs byte-identical to the reference store's for
  the same blocks (auto, deflate-full, lossy-fz on f32, and raw), each
  store restoring the other's blobs; mixed-method groups; a missing key;
* ServingEngine in f32: greedy tokens and ``paging_stats()`` equal to the
  reference engine's, dense and under the TIGHT budget of
  tests/test_serving_paged.py (prefetch off, on and async);
* ServingEngine in bf16 (the port alone): paged tokens bit-identical to the
  port's dense tokens, with prefetch off, on and async, and the hybrid
  sliding-window config retiring its dead blocks.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro.serving import engine as jengine, kvcache as jkv, paging as jpaging
from repro_torch import configs
from repro_torch.core import format as fmt
from repro_torch.models import convert, model as tmodel
from repro_torch.serving import engine as tengine, kvcache as tkv, paging as tpaging

from _torch_model_ref import pair
from _torch_threads import _one_thread  # noqa: F401

TIGHT = dict(kv_offload=True, block_tokens=8, budget_blocks=8)
PREFETCH = {"off": dict(kv_prefetch=False), "on": {}, "async": dict(async_prefetch=True)}


def _outcome(fn):
    """What a call returns, or the type of what it raises."""
    try:
        return fn()
    except (RuntimeError, ValueError) as e:
        return type(e)


# ------------------------------------------------------------------ paging


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_step_for_step(seed):
    rng = np.random.default_rng(seed)
    a, b = jpaging.BlockPoolAllocator(6), tpaging.BlockPoolAllocator(6)
    for _ in range(200):
        if rng.random() < 0.55:
            got = _outcome(b.alloc)
            assert got == _outcome(a.alloc)
        else:
            slot = int(rng.integers(0, 7))
            assert _outcome(lambda: b.free(slot)) == _outcome(lambda: a.free(slot))
        assert (b.allocated, b.free_blocks, b.high_water) == (a.allocated, a.free_blocks,
                                                               a.high_water)
    with pytest.raises(ValueError, match="budget_blocks"):
        tpaging.BlockPoolAllocator(0)


def test_allocator_errors_name_the_budget():
    a = tpaging.BlockPoolAllocator(2)
    a.alloc(), a.alloc()
    with pytest.raises(RuntimeError, match="budget=2"):
        a.alloc()
    a.free(0)
    with pytest.raises(ValueError, match="double free"):
        a.free(0)


def test_prefetch_queue_step_for_step():
    rng = np.random.default_rng(3)
    q, r = tpaging.PrefetchQueue(2), jpaging.PrefetchQueue(2)
    for _ in range(100):
        if rng.random() < 0.7:
            key = ("k", int(rng.integers(0, 5)))
            q.push(key), r.push(key)
        else:
            assert q.pop_all() == r.pop_all()
        assert len(q) == len(r)


@pytest.mark.parametrize("seed", [0, 1])
def test_tracker_step_for_step(seed):
    rng = np.random.default_rng(seed)
    t, r = tkv.PagedKVTracker(4, 3), jkv.PagedKVTracker(4, 3)
    for _ in range(150):
        op = rng.integers(0, 4)
        if op == 0:
            sid, pos = int(rng.integers(0, 3)), int(rng.integers(0, 32))
            t.touch(sid, pos), r.touch(sid, pos)
        elif op == 1:
            key = ("b", int(rng.integers(0, 8)))
            t.touch_block(key), r.touch_block(key)
        elif op == 2:
            key = ("b", int(rng.integers(0, 8)))
            t.drop(key), r.drop(key)
        n, prot = int(rng.integers(0, 6)), {("b", int(rng.integers(0, 8)))}
        assert t.candidates(n, protected=prot) == r.candidates(n, protected=prot)
        assert t.eviction_candidates() == r.eviction_candidates()


# ------------------------------------------------------------------- store


def _blocks(dtype, n=5):
    rng = np.random.default_rng(2)
    out = []
    for i in range(n):
        b = (rng.normal(size=(32, 4, 16)) * 0.02).astype(dtype)
        b[8:16] = b[0:8]
        out.append((("s", i), b))
    out.append((("ragged", 0), np.zeros((4, 16), dtype)))
    return out


STORES = {
    "auto": (dict(), np.float32),
    "deflate-full": (dict(backend="deflate-full"), np.float32),
    "lossy-f32": (dict(lossy_eb=1e-3), np.float32),
    "raw": (dict(compress=False), np.float16),
}


@pytest.mark.parametrize("mode", list(STORES))
def test_store_blobs_byte_identical_and_cross(mode):
    kw, dtype = STORES[mode]
    items = _blocks(dtype)
    ref, port = jkv.KVBlockStore(**kw), tkv.KVBlockStore(device="cpu", **kw)
    ref.evict_many(items)
    port.evict_many(items)
    assert port.config.backend == ref.config.backend
    assert list(port._store) == list(ref._store)
    for key, (codec, meta, blob) in ref._store.items():
        pc, pm, pb = port._store[key]
        assert (pc, pm) == (codec, meta)
        assert bytes(pb) == bytes(blob), key
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    keys = [k for k, _ in items]
    # each store restores the other's blobs
    ref_blobs, port_blobs = dict(ref._store), dict(port._store)
    port._store, ref._store = ref_blobs, port_blobs
    got, want = port.restore_many(keys), ref.restore_many(keys)
    for (key, block), g, w in zip(items, got, want):
        assert g.dtype == block.dtype and g.shape == block.shape
        assert np.array_equal(g, w), key
        if mode == "lossy-f32":
            assert np.abs(g - block).max() <= np.float32(1e-3)
        else:
            assert np.array_equal(g, block)
    assert port.stats.restore_dispatches == ref.stats.restore_dispatches


def test_store_tensor_blocks_store_numpy_bytes():
    """A tensor block is stored as the same bytes as its numpy twin; bf16
    restores as uint16 bits."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 1 << 16, (64, 16)).astype(np.uint16)
    bits[32:] = bits[:32]
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    port, ref = tkv.KVBlockStore(device="cpu"), jkv.KVBlockStore()
    port.evict("t", t)
    ref.evict("t", bits)
    assert bytes(port._store["t"][2]) == bytes(ref._store["t"][2])
    out = port.restore("t")
    assert out.dtype == np.uint16 and np.array_equal(out, bits)
    with pytest.raises(ValueError, match="float32 blocks only"):
        tkv.KVBlockStore(lossy_eb=1e-3, device="cpu").evict("t", t)


def test_restore_many_mixed_method_store_groups_by_method():
    """Raw and deflate-full blobs in one store split into one restore per
    method group (the reference's regression test, tests/test_serving_paged.py)."""
    rng = np.random.default_rng(7)
    blocks = {("v1", i): np.repeat(rng.integers(0, 255, 512).astype(np.uint8), 4)
              for i in range(2)}
    blocks.update({("v2", i): np.repeat(rng.integers(0, 255, 512).astype(np.uint8), 4)
                   for i in range(2)})
    store = tkv.KVBlockStore(compress=True, backend="torch", device="cpu")
    store.evict_many([(k, v) for k, v in blocks.items() if k[0] == "v1"])
    store.config = dataclasses.replace(store.config, backend="deflate-full")
    store.evict_many([(k, v) for k, v in blocks.items() if k[0] == "v2"])
    assert [fmt.parse_header(store._store[k][2]).method for k in blocks] == [0, 0, 1, 1]
    keys = list(blocks)  # interleaves both methods in one restore round
    for k, got in zip(keys, store.restore_many(keys)):
        assert np.array_equal(got, blocks[k])
    assert store.stats.restore_dispatches == 2  # one per method group


def test_restore_many_missing_key_loses_nothing():
    for compress in (False, True):
        store = tkv.KVBlockStore(compress=compress, device="cpu")
        store.evict("a", np.zeros((4, 4), np.float32))
        with pytest.raises(KeyError):
            store.restore_many(["a", "missing"])
        assert "a" in store and len(store) == 1
        assert np.array_equal(store.restore("a"), np.zeros((4, 4), np.float32))


def test_store_mesh_picks_the_sharded_pair():
    store = tkv.KVBlockStore(mesh=("cpu", "cpu"), device="cpu")
    assert (store.config.backend, store.config.decoder) == ("sharded", "sharded")
    items = _blocks(np.float32)
    store.evict_many(items)
    ref = tkv.KVBlockStore(device="cpu")
    ref.evict_many(items)
    assert all(bytes(store._store[k][2]) == bytes(ref._store[k][2]) for k, _ in items)
    with pytest.raises(ValueError, match="batch_axis requires mesh"):
        tkv.KVBlockStore(batch_axis="data", device="cpu")


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def llama_f32():
    jcfg, tcfg = pair("llama3.2-1b")
    jp = jmodel.init_params(jcfg, 0)
    return jcfg, jp, tcfg, convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                                     device="cpu")


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(0).integers(0, 256, (2, 8)).astype(np.int32)


def _store_stats(engine):
    """The store's counters but the stored bytes: those depend on the K/V
    values, which the two packages compute within about 1e-6 of each other
    in f32 (not bit for bit), so compressed sizes may differ.  The stores
    themselves give equal bytes for equal blocks (tests above)."""
    s = dataclasses.asdict(engine.kv_store.stats)
    s.pop("evicted_bytes_stored")
    return s


def _run(llama, prompts, port, new_tokens=16, **kw):
    """Generate through the reference's engine or the port's."""
    jcfg, jp, tcfg, tp = llama
    eng = (tengine.ServingEngine(tcfg, tp, max_len=64, device="cpu", **kw) if port
           else jengine.ServingEngine(jcfg, jp, max_len=64, **kw))
    return eng.generate(prompts, max_new_tokens=new_tokens), eng


@pytest.fixture(scope="module")
def ref_dense_f32(llama_f32, prompts):
    return _run(llama_f32, prompts, port=False)[0]


def test_engine_dense_f32_tokens_equal_reference(llama_f32, prompts, ref_dense_f32):
    p, _ = _run(llama_f32, prompts, port=True)
    assert p.steps == ref_dense_f32.steps
    np.testing.assert_array_equal(p.tokens, ref_dense_f32.tokens)
    np.testing.assert_array_equal(p.tokens[:, :8], prompts)  # teacher-forced


@pytest.mark.parametrize("prefetch", list(PREFETCH))
def test_engine_paged_f32_tokens_and_stats_equal_reference(llama_f32, prompts, ref_dense_f32,
                                                           prefetch):
    kw = dict(kv_compress=True, **TIGHT, **PREFETCH[prefetch])
    r, ref = _run(llama_f32, prompts, port=False, **kw)
    p, port = _run(llama_f32, prompts, port=True, **kw)
    np.testing.assert_array_equal(p.tokens, r.tokens)
    np.testing.assert_array_equal(p.tokens, ref_dense_f32.tokens)
    assert port.paging_stats() == ref.paging_stats()
    assert _store_stats(port) == _store_stats(ref)
    s = port.paging_stats()
    assert s["working_set_blocks"] > port.budget_blocks >= s["high_water"]
    assert port.kv_store.stats.evictions > 0 and port.kv_store.stats.restores > 0


@pytest.mark.parametrize("codec", ["deflate-full", "raw"])
def test_engine_paged_f32_other_codecs(llama_f32, prompts, ref_dense_f32, codec):
    """The codec changes no token and no paging decision; raw blocks
    dispatch nothing.  4 new tokens under a budget of 4 blocks (the plain
    gap decoder is a 512-step loop a container on the CPU)."""
    kw = dict(kv_compress=False) if codec == "raw" else dict(kv_compress=True, kv_backend=codec)
    small = dict(kv_offload=True, block_tokens=8, budget_blocks=4, new_tokens=4)
    p, port = _run(llama_f32, prompts, port=True, **small, **kw)
    _, auto = _run(llama_f32, prompts, port=True, kv_compress=True, **small)
    np.testing.assert_array_equal(p.tokens, ref_dense_f32.tokens[:, :12])
    assert port.paging_stats() == auto.paging_stats()
    s = port.kv_store.stats
    assert s.restores > 0 and s.restores == auto.kv_store.stats.restores
    if codec == "raw":
        assert s.restore_dispatches == s.eviction_dispatches == 0
    else:
        assert s.restore_dispatches == auto.kv_store.stats.restore_dispatches


@pytest.fixture(scope="module")
def llama_bf16():
    cfg = configs.reduced_config(configs.get_config("llama3.2-1b"))
    return cfg, tmodel.init_params(cfg, 0, device="cpu")


@pytest.fixture(scope="module")
def dense_bf16(llama_bf16, prompts):
    cfg, params = llama_bf16
    return tengine.ServingEngine(cfg, params, max_len=64, device="cpu").generate(
        prompts, max_new_tokens=16).tokens


@pytest.mark.parametrize("prefetch", list(PREFETCH))
def test_engine_paged_bf16_bit_identical_to_dense(llama_bf16, prompts, dense_bf16, prefetch):
    cfg, params = llama_bf16
    eng = tengine.ServingEngine(cfg, params, max_len=64, kv_compress=True, device="cpu",
                                **TIGHT, **PREFETCH[prefetch])
    np.testing.assert_array_equal(eng.generate(prompts, max_new_tokens=16).tokens, dense_bf16)
    s = eng.paging_stats()
    assert s["high_water"] <= eng.budget_blocks < s["working_set_blocks"]
    assert (s["prefetch_hits"] > 0) == (prefetch != "off")
    assert (s["async_prefetch_batches"] > 0) == (prefetch == "async")
    # a second generate() drops the first one's stored blocks
    before = eng._gen_id
    eng.generate(prompts, max_new_tokens=16)
    assert {k[0] for k in eng.kv_store.keys()} <= {before + 1}


def test_engine_hybrid_swa_retires_dead_blocks(prompts):
    cfg = configs.reduced_config(configs.get_config("hymba-1.5b"))
    params = tmodel.init_params(cfg, 0, device="cpu")
    # 24 new tokens: the window (16) slides past the first 8-token block
    want = tengine.ServingEngine(cfg, params, max_len=64, device="cpu").generate(
        prompts, max_new_tokens=24).tokens
    eng = tengine.ServingEngine(cfg, params, max_len=64, kv_compress=True, kv_offload=True,
                                block_tokens=8, budget_blocks=8, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, max_new_tokens=24).tokens, want)
    s = eng.paging_stats()
    assert s["high_water"] <= 8 < s["working_set_blocks"]
    assert any(v > 0 for v in eng._retired_upto.values())
    dead = [(layer, sid, blk) for (layer, sid), lo in eng._retired_upto.items()
            for blk in range(lo)]
    assert dead and not any(k in eng._slot or eng._store_key(k) in eng.kv_store for k in dead)


def test_engine_errors(llama_bf16, prompts, monkeypatch):
    cfg, params = llama_bf16
    eng = tengine.ServingEngine(cfg, params, max_len=64, kv_compress=True, kv_offload=True,
                                block_tokens=8, budget_blocks=4, device="cpu")
    with pytest.raises(ValueError, match="peak per-layer working set"):
        eng.generate(prompts, max_new_tokens=16)
    with pytest.raises(ValueError, match="block_tokens"):
        tengine.ServingEngine(cfg, params, max_len=60, kv_offload=True, block_tokens=8,
                              device="cpu")
    with pytest.raises(NotImplementedError):
        tengine.ServingEngine(dataclasses.replace(cfg, kv_quant=True), params, max_len=64,
                              kv_offload=True, block_tokens=8, device="cpu")
    with pytest.raises(NotImplementedError, match="mixers"):
        tengine.ServingEngine(dataclasses.replace(cfg, mixer="ssm"), params, max_len=64,
                              kv_offload=True, block_tokens=8, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        tengine.ServingEngine(cfg, params, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkv.KVBlockStore().evict("a", np.zeros(8, np.float32))
