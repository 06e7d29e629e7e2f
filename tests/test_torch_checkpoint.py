"""The port's checkpoint manager (repro_torch.checkpoint.manager), in the
port alone and against the reference package's, on the CPU.

In the port: bit-exact restore, compression of structured state, CRC
fallback, retention, no staging dir left, one ``compress_many`` per
dtype-class group.  Across the packages: the same state saved by both
managers gives byte-identical step directories (every file, the manifest
included) for a plain tree with lists and for the reduced llama3.2-1b's
train state, in both write modes; steps cross both ways bit for bit; lossy
f32 leaves give byte-identical containers and restore within eb.  No
tolerance but eb: everything else is compared bit for bit.  The
reference's saves (jit compiles, about 10 s the first) run once per module.
"""

import filecmp
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.configs.base import TrainConfig as JTrain
from repro.launch import steps as jsteps
from repro_torch.checkpoint import manager as tmanager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import steps
from repro_torch.models import convert
from repro_torch.sharding.rules import Placement

import _ckpt_golden as golden
from _torch_model_ref import pair

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on the host's cores, and idle threads spinning slow them all."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _mgr(path, **kw):
    return CheckpointManager(str(path), device="cpu", **kw)


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


@pytest.fixture
def state():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {
            "w": torch.randn((64, 64), generator=g),
            "e": (torch.randn((128, 32), generator=g) * 0.01).to(torch.bfloat16),
        },
        "opt": {"m": torch.zeros((64, 64))},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(tree):
    return [leaf for _, leaf in tmanager._flatten(tree)]


def _assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)


def _assert_dirs_identical(d1, d2):
    cmp = filecmp.dircmp(d1, d2)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only, cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(d1, d2, cmp.common_files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    assert "manifest.json" in cmp.common_files and jmanager.COMMIT_MARKER in cmp.common_files


# ------------------------------------------------------------- the port


def test_save_restore_bit_exact(tmp_path, state):
    mgr = _mgr(tmp_path)
    mgr.save(state, 1)
    restored, step = mgr.restore_latest(state)
    assert step == 1
    _assert_tree_equal(state, restored)
    assert all(t.device == CPU for t in _leaves(restored))


def test_compression_helps_on_structured_state(tmp_path):
    # optimizer moments start at zero: hugely compressible
    mgr = _mgr(tmp_path)
    mgr.save({"m": torch.zeros((512, 512))}, 1)
    assert mgr.stats(1)["ratio"] > 20


def test_crc_detects_corruption_and_falls_back(tmp_path, state):
    mgr = _mgr(tmp_path, keep=5)
    mgr.save(state, 1)
    mgr.save(state, 2)
    files = sorted(glob.glob(os.path.join(str(tmp_path), "step_00000002", "*.gplz")),
                   key=os.path.getsize)
    with open(files[-1], "r+b") as f:
        f.seek(os.path.getsize(files[-1]) // 2)
        f.write(b"\xa5" * 32)
    restored, step = mgr.restore_latest(state)
    assert step == 1  # fell back past the damaged step
    _assert_tree_equal(state, restored)


def test_retention_gc(tmp_path, state):
    mgr = _mgr(tmp_path, compress=False, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, s)
    assert mgr.steps() == [3, 4]


def test_no_tmp_dirs_left(tmp_path, state):
    mgr = _mgr(tmp_path, compress=False)
    mgr.save(state, 1)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_save_batches_dtype_classes(tmp_path, state, monkeypatch):
    """Leaves of a dtype class go through one batched dispatch, not one
    compress() call per leaf."""
    calls = {"many": [], "single": 0}
    real_many = tmanager.lzss.compress_many

    def counting_many(arrays, cfg, device=None):
        calls["many"].append((cfg.symbol_size, len(arrays)))
        return real_many(arrays, cfg, device=device)

    def forbidden_single(*a, **k):
        calls["single"] += 1
        raise AssertionError("save() must use the batched pipeline API")

    monkeypatch.setattr(tmanager.lzss, "compress_many", counting_many)
    monkeypatch.setattr(tmanager.lzss, "compress", forbidden_single)
    mgr = _mgr(tmp_path)
    mgr.save(state, 1)
    assert calls["single"] == 0
    # two f32 (64, 64) leaves share S=4 and a chunk-count bucket; the bf16
    # leaf is S=2: two groups, two dispatches
    assert sorted(calls["many"]) == [(2, 1), (4, 2)]
    restored, step = mgr.restore_latest(state)
    assert step == 1
    _assert_tree_equal(state, restored)


def test_restore_places_leaves_where_shardings_say(tmp_path, state):
    mgr = _mgr(tmp_path)
    mgr.save(state, 1)
    for sh in (CPU, "cpu", Placement(CPU, ())):
        restored, _ = mgr.restore(state, 1, shardings=sh)
        _assert_tree_equal(state, restored)
    tree_sh = {"params": {"w": CPU, "e": Placement(CPU, ("data",))}, "opt": {"m": CPU},
               "step": CPU}
    restored, _ = mgr.restore(state, 1, shardings=tree_sh)
    _assert_tree_equal(state, restored)
    with pytest.raises(ValueError):
        mgr.restore(state, 1, shardings={"params": CPU})


def test_train_state_round_trip_in_the_port(tmp_path):
    _, tcfg = pair("llama3.2-1b")
    st = steps.init_train_state(tcfg, None, 3, device="cpu")
    st["opt"]["m"] = {n: torch.full_like(v, 0.25) for n, v in st["opt"]["m"].items()}
    st["step"] = st["step"] + 5
    mgr = _mgr(tmp_path)
    mgr.save(st, 5)
    restored, step = mgr.restore_latest(steps.abstract_train_state(tcfg, None))
    assert step == 5 and int(restored["step"]) == 5
    _assert_tree_equal(convert.train_state_tree(st), convert.train_state_tree(restored))
    assert all(p.requires_grad for p in restored["params"].parameters())
    assert set(restored["opt"]["v"]) == {n for n, _ in st["params"].named_parameters()}


def test_leaf_names_follow_jax_tree_paths():
    tree = {"b": [np.zeros(3), {"y": np.ones(2), "x": (np.int32(1), np.zeros(1))}],
            "a": None, "c": np.float32(2.0), 7: np.zeros(1)}
    jtree = {k: v for k, v in tree.items() if k != 7}
    want = jmanager._leaf_paths(jtree)[0]
    names, leaves, _ = tmanager._leaf_paths(jtree)
    assert names == want == ["b/[0]", "b/[1]/x/[0]", "b/[1]/x/[1]", "b/[1]/y", "c"]
    assert len(leaves) == 5


def test_train_state_converter_round_trip():
    jst, st, _ = _train_states()
    jst = jax.tree.map(np.asarray, jst)
    back = convert.train_state_to_numpy(st)
    flat_j = jax.tree_util.tree_flatten_with_path(jst)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (p, a), (_, b) in zip(flat_j, flat_t):
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), p


# ------------------------------------------------------ across packages


def _reference_tree(a: dict) -> dict:
    """The golden tree (tests/_ckpt_golden.py) with the reference's arrays."""
    return {"blocks": [a["w"], {"e": a["e_bits"].view(jnp.bfloat16), "ids": a["ids"]}],
            "head": (a["small"],), "none": None, "step": a["step"]}


def _plain_trees():
    """The same plain tree (lists, a tuple, None, a scalar, bf16) for the
    reference (numpy) and the port (tensors)."""
    return _reference_tree(golden.arrays()), golden.torch_tree()


@functools.lru_cache(maxsize=None)
def _reference_train_state(seed):
    jcfg, _ = pair("llama3.2-1b", dtype="bfloat16")
    jst = jsteps.init_train_state(jcfg, JTrain(), seed)
    # non-zero moments, as after a step, so the f32 groups carry real data
    rng = np.random.default_rng(seed)
    jst["opt"] = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 1e-3),
        jst["opt"])
    return jst


def _train_states(seed=0):
    """The reference's train state and the port's, holding the same bits."""
    _, tcfg = pair("llama3.2-1b", dtype="bfloat16")
    jst = _reference_train_state(seed)
    tst = convert.train_state_from_numpy(jax.tree.map(np.asarray, jst), tcfg, device="cpu")
    return jst, tst, tcfg


EB = 1e-3


@pytest.fixture(scope="module")
def reference_dirs(tmp_path_factory):
    """Step directories written by the reference's manager, once."""
    root = tmp_path_factory.mktemp("ref")
    jtree, _ = _plain_trees()
    jst, _, _ = _train_states()
    out = {}
    for kind, tree in (("plain", jtree), ("train", jst)):
        for async_writes in (False, True):
            d = root / f"{kind}_{int(async_writes)}"
            m = jmanager.CheckpointManager(str(d), async_writes=async_writes)
            m.save(tree, 4)
            m.wait_until_finished()
            out[kind, async_writes] = d
    d = root / "lossy"
    jmanager.CheckpointManager(str(d), lz_lossy_eb=EB).save(jst, 4)
    out["lossy"] = d
    return out


@pytest.mark.parametrize("async_writes", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("kind", ["plain", "train"])
def test_step_dirs_byte_identical_across_packages(tmp_path, reference_dirs, kind, async_writes):
    tree = _plain_trees()[1] if kind == "plain" else _train_states()[1]
    mgr = _mgr(tmp_path, async_writes=async_writes)
    mgr.save(tree, 4)
    mgr.wait_until_finished()
    _assert_dirs_identical(str(reference_dirs[kind, async_writes] / "step_00000004"),
                           str(tmp_path / "step_00000004"))


def test_reference_step_restores_in_the_port(reference_dirs):
    jtree, ttree = _plain_trees()
    got, step = _mgr(reference_dirs["plain", False]).restore_latest(ttree)
    assert step == 4
    _assert_tree_equal(ttree, got)
    jst, tst, tcfg = _train_states()
    got, step = _mgr(reference_dirs["train", True]).restore_latest(
        steps.abstract_train_state(tcfg, None), CPU)
    assert step == 4
    _assert_tree_equal(convert.train_state_tree(tst), convert.train_state_tree(got))


def test_port_step_restores_in_the_reference(tmp_path):
    jtree, ttree = _plain_trees()
    jst, tst, _ = _train_states(seed=1)
    for name, (jt, tt) in {"plain": (jtree, ttree), "train": (jst, tst)}.items():
        _mgr(tmp_path / name).save(tt, 9)
        got, step = jmanager.CheckpointManager(str(tmp_path / name)).restore_latest(
            jax.eval_shape(lambda: jt))
        assert step == 9
        for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(got)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def test_lossy_leaves_cross_packages_within_eb(tmp_path, reference_dirs):
    jst, tst, tcfg = _train_states()
    mgr = _mgr(tmp_path, lz_lossy_eb=EB)
    mgr.save(tst, 4)
    _assert_dirs_identical(str(reference_dirs["lossy"] / "step_00000004"),
                           str(tmp_path / "step_00000004"))
    import json

    entries = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())["leaves"]
    lossy = {e["name"] for e in entries if e.get("lossy")}
    assert lossy and all(e["dtype"] == "float32" for e in entries if e["name"] in lossy)
    got, _ = _mgr(reference_dirs["lossy"]).restore_latest(steps.abstract_train_state(tcfg, None))
    want = convert.train_state_tree(tst)
    have = convert.train_state_tree(got)
    for (path, a), (_, b) in zip(tmanager._flatten(want), tmanager._flatten(have)):
        name = "/".join(path)
        if name in lossy:
            assert float((a - b).abs().max()) <= np.float32(EB), name
        else:
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b), name


def test_golden_step_is_the_reference_managers(tmp_path):
    """tests/golden_ckpt holds what the reference's manager writes for the
    golden tree today (the card tests restore it), and the port restores
    it bit for bit."""
    jmanager.CheckpointManager(str(tmp_path)).save(_reference_tree(golden.arrays()), golden.STEP)
    step_dir = f"step_{golden.STEP:08d}"
    _assert_dirs_identical(str(tmp_path / step_dir), os.path.join(golden.DIRECTORY, step_dir))
    got, step = _mgr(golden.DIRECTORY).restore_latest(golden.torch_tree())
    assert step == golden.STEP
    _assert_tree_equal(golden.torch_tree(), got)
