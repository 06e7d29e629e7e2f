"""The port's crash-consistency, fault-injection and concurrency-stress
harness for the async double-buffered checkpoint write path
(repro_torch/runtime/async_io.py), ported from tests/test_async_io.py: the
same cases against the port's manager, writer and fault seam, on the CPU
(the codec's plain PyTorch path), tensors in place of arrays.  Restores
are compared bit for bit.

Contracts under test:
  * crash consistency — a simulated process death at EVERY write boundary
    of a save (blob files, manifest, commit marker, the rename itself)
    never yields a restorable-but-corrupt checkpoint: ``steps()`` omits
    the partial step and ``restore_latest`` returns the previous step
    bit-exactly, in both sync and async modes;
  * fault injection — transient EIO retries under the bounded,
    deterministic ``RetryPolicy``; ENOSPC surfaces as a clean
    ``AsyncWriteError`` (a ``RuntimeError``) naming the step and path on
    the next ``save()``/``wait_until_finished()``, never a silent drop;
  * concurrency stress — saves racing GC and a concurrent
    ``restore_latest`` never deadlock and never observe a torn step;
    async-on and sync-on write byte-identical checkpoint directories.

Every thread join and wait in these tests is bounded.
"""

import errno
import filecmp
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager as tmanager
from repro_torch.checkpoint.manager import COMMIT_MARKER
from repro_torch.runtime.async_io import (
    AsyncBlobWriter,
    AsyncWriteError,
    RetryPolicy,
)
from repro_torch.runtime.fault import (
    FaultSpec,
    FaultyFS,
    HostFS,
    SimulatedCrash,
    StepGuard,
)

from _torch_threads import _one_thread  # noqa: F401

FAST_RETRY = RetryPolicy(max_attempts=3, backoff_s=0.001)


def CheckpointManager(directory, **kw):
    """The port's manager with its codec on the CPU."""
    return tmanager.CheckpointManager(directory, device="cpu", **kw)


def _state(salt: int = 0):
    """Small mixed tree: one compressible f32 leaf (>=1KiB -> .gplz), one
    tiny raw leaf, one scalar."""
    rng = np.random.default_rng(7)
    return {
        "w": torch.from_numpy((rng.standard_normal((40, 40)) + salt).astype(np.float32)),
        "b": torch.arange(8, dtype=torch.int32) + salt,
        "step": torch.tensor(salt, dtype=torch.int32),
    }


def _template(state):
    return {k: torch.empty_like(v, device="meta") for k, v in state.items()}


def _assert_tree_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _assert_dirs_identical(d1, d2):
    cmp = filecmp.dircmp(d1, d2)
    assert not cmp.left_only and not cmp.right_only, (
        cmp.left_only,
        cmp.right_only,
    )
    match, mismatch, errors = filecmp.cmpfiles(
        d1, d2, cmp.common_files, shallow=False
    )
    assert not mismatch and not errors, (mismatch, errors)
    for sub in cmp.common_dirs:
        _assert_dirs_identical(os.path.join(d1, sub), os.path.join(d2, sub))


# ------------------------------------------------------------ writer units


def test_writer_preserves_op_order(tmp_path):
    order = []

    class SpyFS(HostFS):
        def write_bytes(self, path, data):
            order.append(os.path.basename(path))
            super().write_bytes(path, data)

    w = AsyncBlobWriter(fs=SpyFS())
    w.begin_step(1)
    for name in ("a", "b", "manifest.json", COMMIT_MARKER):
        w.put_write(1, str(tmp_path / name), b"x")
    w.wait_until_finished()
    w.close()
    assert order == ["a", "b", "manifest.json", COMMIT_MARKER]


def test_writer_backpressure_bounds_inflight_steps(tmp_path):
    fs = FaultyFS(
        faults=[FaultSpec(op="write", mode="delay", delay_s=0.05, count=10**9)]
    )
    w = AsyncBlobWriter(fs=fs, max_pending_steps=2)
    for label in (1, 2):
        tmp = tmp_path / f"s{label}.tmp"
        tmp.mkdir()
        blocked = w.begin_step(label)
        assert blocked < 0.04  # window not full: no backpressure yet
        w.put_write(label, str(tmp / "blob"), b"z" * 8)
        w.put_commit(label, str(tmp), str(tmp_path / f"d{label}"))
    # third step must wait for a slot: the double-buffer bound
    t0 = time.monotonic()
    blocked = w.begin_step(3)
    assert blocked > 0.01
    assert time.monotonic() - t0 >= blocked
    assert w.stats()["blocked_s"] >= blocked
    w.wait_until_finished()
    w.close()


def test_retry_policy_deterministic_attempts():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError(errno.EIO, "io")
        return "ok"

    assert FAST_RETRY.run(flaky) == "ok"
    assert len(calls) == 3  # 2 transient failures + 1 success, bounded

    calls.clear()

    def dead():
        calls.append(1)
        raise OSError(errno.EIO, "io")

    with pytest.raises(OSError):
        FAST_RETRY.run(dead)
    assert len(calls) == FAST_RETRY.max_attempts


def test_retry_policy_never_retries_enospc():
    calls = []

    def full():
        calls.append(1)
        raise OSError(errno.ENOSPC, "disk full")

    with pytest.raises(OSError):
        FAST_RETRY.run(full)
    assert len(calls) == 1  # a full disk does not heal by waiting


def test_faultyfs_is_deterministic(tmp_path):
    def run(seed):
        fs = FaultyFS(
            faults=[FaultSpec(op="write", probability=0.3, count=10**9)],
            seed=seed,
        )
        outcomes = []
        for i in range(20):
            try:
                fs.write_bytes(str(tmp_path / f"f{i}"), b"x")
                outcomes.append("ok")
            except OSError:
                outcomes.append("err")
        return outcomes

    assert run(3) == run(3)  # same seed -> same fault sequence
    assert "err" in run(3) and "ok" in run(3)


# ---------------------------------------------------- crash consistency


def _boundary_ops(tmp_path, async_writes):
    """Enumerate the write boundaries of one save by logging a clean run."""
    fs = FaultyFS()
    mgr = CheckpointManager(
        str(tmp_path), compress=True, keep=5, fs=fs,
        async_writes=async_writes, io_retry=FAST_RETRY,
    )
    mgr.save(_state(1), 1)
    mgr.save(_state(2), 2)
    mgr.wait_until_finished()
    # keep EVERY instrumented op touching the step so the count lines up
    # exactly with the replay spec's matching-call counter (op="*")
    ops = [(op, p) for op, p in fs.log if "step_00000002" in p]
    assert any(op == "rename" for op, _ in ops)
    assert any(COMMIT_MARKER in p for _, p in ops)
    return len(ops)


@pytest.mark.parametrize("async_writes", [False, True])
def test_crash_at_every_write_boundary(tmp_path, async_writes):
    """Injected abort at each boundary of step 2's save: step 1 must stay
    the restorable latest, bit-exact; step 2 must never be listed."""
    n_ops = _boundary_ops(tmp_path / "clean", async_writes)
    assert n_ops >= 5  # makedirs + blobs + manifest + marker + rename
    for nth in range(1, n_ops + 1):
        d = tmp_path / f"crash_{int(async_writes)}_{nth}"
        fs = FaultyFS(faults=[FaultSpec(
            op="*", nth=nth, mode="crash", partial=0.5,
            path_substr="step_00000002",
        )])
        mgr = CheckpointManager(
            str(d), compress=True, keep=5, fs=fs,
            async_writes=async_writes, io_retry=FAST_RETRY,
        )
        mgr.save(_state(1), 1)
        mgr.wait_until_finished()
        with pytest.raises(SimulatedCrash):
            # async surfaces the crash at the wait barrier; sync raises
            # from save() itself — either way it must escape untouched
            mgr.save(_state(2), 2)
            mgr.wait_until_finished()
        assert fs.faults[0].hits == 1
        # reader-side view after the "reboot": fresh manager, healthy fs
        reborn = CheckpointManager(str(d), compress=True, keep=5)
        assert reborn.steps() == [1]
        restored, step = reborn.restore_latest(_template(_state(1)))
        assert step == 1
        _assert_tree_equal(restored, _state(1))


def test_crashed_async_step_is_partial_on_disk(tmp_path):
    """The crash really does tear the file: partial bytes, no marker, no
    published dir — the boundary sweep is not vacuous."""
    fs = FaultyFS(faults=[FaultSpec(
        op="write", nth=3, mode="crash", partial=0.5,
        path_substr="step_00000002",
    )])
    mgr = CheckpointManager(
        str(tmp_path), compress=True, keep=5, fs=fs,
        async_writes=True, io_retry=FAST_RETRY,
    )
    mgr.save(_state(1), 1)
    mgr.wait_until_finished()
    with pytest.raises(SimulatedCrash):
        mgr.save(_state(2), 2)
        mgr.wait_until_finished()
    leftover = tmp_path / "step_00000002.tmp"
    assert leftover.is_dir()  # never renamed
    assert not (leftover / COMMIT_MARKER).exists()


# ------------------------------------------------------- fault injection


def test_transient_eio_retries_then_succeeds(tmp_path):
    spec = FaultSpec(op="write", nth=1, count=2, error=errno.EIO,
                     path_substr="step_00000001")
    fs = FaultyFS(faults=[spec])
    mgr = CheckpointManager(
        str(tmp_path), compress=True, fs=fs,
        async_writes=True, io_retry=FAST_RETRY,
    )
    mgr.save(_state(1), 1)
    mgr.wait_until_finished()  # both transient hits absorbed by retry
    assert spec.hits == 2
    restored, step = mgr.restore_latest(_template(_state(1)))
    assert step == 1
    _assert_tree_equal(restored, _state(1))


def test_exhausted_retries_fail_the_step(tmp_path):
    spec = FaultSpec(op="write", nth=1, count=FAST_RETRY.max_attempts,
                     error=errno.EIO, path_substr="step_00000002")
    fs = FaultyFS(faults=[spec])
    mgr = CheckpointManager(
        str(tmp_path), compress=True, fs=fs,
        async_writes=True, io_retry=FAST_RETRY,
    )
    mgr.save(_state(1), 1)
    mgr.save(_state(2), 2)
    with pytest.raises(AsyncWriteError):
        mgr.wait_until_finished()
    assert spec.hits == FAST_RETRY.max_attempts
    assert mgr.steps() == [1]


def test_enospc_surfaces_on_next_save_naming_step_and_path(tmp_path):
    fs = FaultyFS(faults=[FaultSpec(
        op="write", nth=1, count=10**9, error=errno.ENOSPC,
        path_substr="step_00000002",
    )])
    mgr = CheckpointManager(
        str(tmp_path), compress=True, fs=fs,
        async_writes=True, io_retry=FAST_RETRY,
    )
    mgr.save(_state(1), 1)
    mgr.save(_state(2), 2)  # fails in the background — no raise here
    with pytest.raises(AsyncWriteError) as exc_info:
        for _ in range(5):  # surfaced on the NEXT save, not silently dropped
            mgr.save(_state(3), 3)
            mgr.wait_until_finished()
        pytest.fail("background ENOSPC never surfaced")
    msg = str(exc_info.value)
    assert "step 2" in msg and "step_00000002" in msg
    assert isinstance(exc_info.value, RuntimeError)
    # the error was surfaced once and cleared: the writer keeps working
    mgr.save(_state(3), 3)
    mgr.wait_until_finished()
    assert mgr.steps() == [1, 3]
    restored, step = mgr.restore_latest(_template(_state(3)))
    assert step == 3
    _assert_tree_equal(restored, _state(3))


def test_failed_step_never_blocks_later_saves(tmp_path):
    """A dead step's tmp dir is swept by GC once nothing owns it."""
    fs = FaultyFS(faults=[FaultSpec(
        op="write", nth=1, count=10**9, error=errno.ENOSPC,
        path_substr="step_00000002",
    )])
    mgr = CheckpointManager(
        str(tmp_path), compress=True, keep=2, fs=fs,
        async_writes=True, io_retry=FAST_RETRY,
    )
    for s in (1, 2, 3, 4, 5):
        try:
            mgr.save(_state(s), s)
        except AsyncWriteError:
            pass
    try:
        mgr.wait_until_finished()
    except AsyncWriteError:
        pass
    assert mgr.steps() == [4, 5]
    assert not (tmp_path / "step_00000002").exists()
    assert not (tmp_path / "step_00000002.tmp").exists()


# ------------------------------------------------------------ GC contract


def test_gc_ignores_and_sweeps_markerless_dir(tmp_path):
    """Regression for the latent _gc race: a step dir without its commit
    marker (hand-planted here, a torn publish in the wild) is never
    listed, never restored, never counts toward retention — and is swept
    as debris by the next GC."""
    mgr = CheckpointManager(str(tmp_path), compress=True, keep=2)
    mgr.save(_state(1), 1)
    mgr.save(_state(2), 2)
    # hand-plant a marker-less (= uncommitted) step dir newer than both
    fake = tmp_path / "step_00000005"
    fake.mkdir()
    (fake / "manifest.json").write_text("{\"step\": 5, \"leaves\": []}")
    assert mgr.steps() == [1, 2]  # never listed
    restored, step = mgr.restore_latest(_template(_state(2)))
    assert step == 2  # never restored
    _assert_tree_equal(restored, _state(2))
    mgr.save(_state(3), 3)  # keep=2 -> GC runs
    # the markerless dir neither blocked GC of step 1 nor survived it,
    # and it never consumed a retention slot
    assert mgr.steps() == [2, 3]
    assert not fake.exists()


def test_gc_never_deletes_inflight_async_step(tmp_path):
    """Saves outpacing a slow disk: GC (running per commit on the worker)
    must never touch a registered-but-uncommitted step, and retention must
    converge once the writer drains."""
    fs = FaultyFS(faults=[FaultSpec(
        op="write", mode="delay", delay_s=0.01, count=10**9,
    )])
    mgr = CheckpointManager(
        str(tmp_path), compress=True, keep=2, fs=fs,
        async_writes=True, io_retry=FAST_RETRY, io_max_pending=2,
    )
    for s in (1, 2, 3, 4):
        mgr.save(_state(s), s)
    mgr.wait_until_finished()
    assert mgr.steps() == [3, 4]
    restored, step = mgr.restore_latest(_template(_state(4)))
    assert step == 4
    _assert_tree_equal(restored, _state(4))
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


# ------------------------------------------------- async/sync equivalence


def test_async_and_sync_checkpoints_byte_identical(tmp_path):
    """Same state, same config: async-on and sync-on must produce
    byte-identical checkpoint directories (same files, same bytes)."""
    sync_dir, async_dir = tmp_path / "sync", tmp_path / "async"
    ms = CheckpointManager(str(sync_dir), compress=True, keep=3)
    ma = CheckpointManager(
        str(async_dir), compress=True, keep=3, async_writes=True
    )
    for s in (1, 2):
        ms.save(_state(s), s)
        ma.save(_state(s), s)
    ma.wait_until_finished()
    assert ms.steps() == ma.steps() == [1, 2]
    for s in (1, 2):
        _assert_dirs_identical(
            str(sync_dir / f"step_{s:08d}"),
            str(async_dir / f"step_{s:08d}"),
        )


# ------------------------------------------------------------- StepGuard


def test_stepguard_accounts_io_backpressure_separately():
    g = StepGuard(threshold=3.0, max_consecutive_slow=2)
    for i in range(5):
        g.observe(i, 0.10)
    # a huge writer stall is an io_stall, NOT a compute straggler
    slow = g.observe(5, 0.10, io_wait_s=1.0)
    assert not slow
    assert g.stats.io_stalls == 1
    assert g.stats.io_wait_steps == 1
    assert g.stats.io_wait_s == pytest.approx(1.0)
    assert not g.should_restart
    # compute EWMA untouched by io waits: a genuinely slow step still flags
    assert g.observe(6, 1.0) is True


def test_stepguard_heartbeat_carries_io_fields(tmp_path):
    hb = tmp_path / "hb.json"
    g = StepGuard(heartbeat_path=str(hb))
    g.observe(0, 0.05, io_wait_s=0.02)
    import json

    data = json.loads(hb.read_text())
    assert data["io_wait_s"] == pytest.approx(0.02)
    assert "io_stalls" in data


# ------------------------------------------------------------ stress lane


@pytest.mark.timeout(300)
def test_saves_race_gc_and_concurrent_restore(tmp_path):
    """N async saves racing worker-side GC while a reader thread hammers
    restore_latest: every observed restore is a committed step restored
    bit-exactly, and nothing deadlocks (pytest-timeout is the net)."""
    fs = FaultyFS(faults=[FaultSpec(
        op="write", mode="delay", delay_s=0.002, count=10**9,
    )])
    mgr = CheckpointManager(
        str(tmp_path), compress=True, keep=2, fs=fs,
        async_writes=True, io_retry=FAST_RETRY,
    )
    template = _template(_state(0))
    stop = threading.Event()
    seen, errors = [], []

    def reader():
        while not stop.is_set():
            try:
                restored, step = mgr.restore_latest(template)
                if step >= 0:
                    seen.append(step)
                    _assert_tree_equal(restored, _state(step))
            except Exception as exc:  # noqa: BLE001 - collected for assert
                errors.append(exc)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    n = 8
    for s in range(1, n + 1):
        mgr.save(_state(s), s)
    mgr.wait_until_finished()
    stop.set()
    th.join(timeout=60)
    assert not th.is_alive()
    assert not errors, errors
    assert mgr.steps() == [n - 1, n]
    restored, step = mgr.restore_latest(template)
    assert step == n
    _assert_tree_equal(restored, _state(n))
    # steps observed mid-race were all committed ones, in save order
    assert all(e >= 0 for e in seen)
    assert seen == sorted(seen)


@pytest.mark.timeout(300)
def test_writer_survives_seeded_chaos(tmp_path):
    """Seeded random EIO chaos under retry: either a save round completes
    and restores bit-exactly, or the failure surfaces as AsyncWriteError —
    never a hang, never a torn restorable step."""
    fs = FaultyFS(
        faults=[FaultSpec(op="write", probability=0.10, error=errno.EIO,
                          count=10**9)],
        seed=11,
    )
    mgr = CheckpointManager(
        str(tmp_path), compress=True, keep=3, fs=fs,
        async_writes=True,
        io_retry=RetryPolicy(max_attempts=4, backoff_s=0.0005),
    )
    failures = 0
    for s in range(1, 9):
        try:
            mgr.save(_state(s), s)
        except AsyncWriteError:
            failures += 1
    try:
        mgr.wait_until_finished()
    except AsyncWriteError:
        failures += 1
    committed = mgr.steps()
    assert committed, "chaos must not wipe out every step"
    restored, step = mgr.restore_latest(_template(_state(0)))
    assert step == committed[-1]
    _assert_tree_equal(restored, _state(step))


@pytest.mark.timeout(300)
def test_resaving_an_inflight_step_waits_for_it(tmp_path):
    """Saving a step again while its first async save is still being
    written (the launcher's last in-loop save and its final save of the
    same step) waits for the first to land instead of removing its
    staging dir under the writer; the second save's bytes win."""
    fs = FaultyFS(faults=[FaultSpec(op="write", mode="delay", delay_s=0.02, count=10**9)])
    mgr = CheckpointManager(str(tmp_path), compress=True, fs=fs, async_writes=True,
                            io_retry=FAST_RETRY)
    mgr.save(_state(1), 4)
    assert 4 in mgr.writer.in_flight()
    mgr.save(_state(2), 4)
    assert mgr.last_save_io_wait_s > 0.0
    mgr.wait_until_finished()
    assert mgr.steps() == [4]
    restored, step = mgr.restore_latest(_template(_state(2)))
    assert step == 4
    _assert_tree_equal(restored, _state(2))
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
