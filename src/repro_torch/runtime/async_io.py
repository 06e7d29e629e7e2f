"""Async double-buffered blob writing for checkpoint/KV host I/O.

The port's own copy of the reference package's module (it imports no JAX,
and ``repro_torch`` imports nothing of ``repro``).  The worker thread does
host I/O only: it makes no CUDA call and touches no tensor; the bytes it
is handed are already ``bytes`` (the producer copies them in
``put_write``), so a device copy has finished before a write is queued.

GPULZ exists so compression never becomes the bottleneck it was built to
remove — but a host-synchronous ``CheckpointManager.save`` stalls the train
step on blob I/O anyway.  This module is the CPU-testable slice of the
ROADMAP's pod-scale item: ``AsyncBlobWriter`` is a single background thread
draining a bounded FIFO of write ops, so the loop hands a step's compressed
blobs off and keeps training while the bytes hit disk.

Ordering and atomicity:
  * one worker thread means a total order over ops — a step's
    ``blobs -> manifest -> commit marker -> rename(tmp, final)`` sequence
    can never interleave or reorder;
  * the commit marker is written *last* inside the tmp dir and the rename
    is the publish point: a crash at any earlier boundary leaves either a
    ``*.tmp`` dir or a marker-less dir, both of which readers
    (``CheckpointManager.steps``) treat as nonexistent;
  * the bounded in-flight window IS the double buffer: with
    ``max_pending_steps=2`` the loop can compress/enqueue step N+1 while
    step N's bytes are still being written, and only blocks (backpressure,
    surfaced to ``StepGuard`` via ``last_blocked_s``) when it runs a full
    step ahead of the disk.

Failure contract:
  * transient ``OSError``s retry under ``RetryPolicy`` (bounded attempts,
    exponential backoff, deterministic); non-retryable errnos (ENOSPC) fail
    immediately;
  * a failed op marks its step failed, drops the step's remaining queued
    ops (its tmp dir is never renamed, so it can never be restored), and
    the error re-raises on the NEXT ``submit``/``wait_until_finished`` as
    an ``AsyncWriteError`` naming the step and path — never a silent drop.
    Surfacing clears the error: later steps proceed (disk may have
    recovered);
  * a ``SimulatedCrash`` from the ``FaultyFS`` seam kills the worker where
    it stands — no cleanup, no retry, mimicking process death — so the
    crash-consistency suite can probe every write boundary.
"""

from __future__ import annotations

import dataclasses
import errno
import queue
import threading
import time

from repro_torch.runtime.fault import HostFS, SimulatedCrash


class AsyncWriteError(RuntimeError):
    """A background write failed; raised on the next enqueue/wait."""

    def __init__(self, label, path: str, cause: BaseException):
        super().__init__(
            f"async write failed for step {label} (path {path!r}): {cause!r}"
        )
        self.label = label
        self.path = path
        self.cause = cause


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-attempt exponential backoff over transient ``OSError``s.

    Deterministic: attempt count and sleep schedule depend only on the
    policy fields, so a seeded ``FaultyFS`` exercising
    fail-fail-succeed always resolves on the same attempt.
    """

    max_attempts: int = 3
    backoff_s: float = 0.005
    backoff_mult: float = 2.0
    # EIO: flaky device; EAGAIN/EINTR: transient kernel conditions.
    # ENOSPC is deliberately absent — a full disk does not heal by waiting.
    retryable: tuple = (errno.EIO, errno.EAGAIN, errno.EINTR)

    def run(self, fn):
        delay = self.backoff_s
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except OSError as exc:
                if exc.errno not in self.retryable:
                    raise
                if attempt == self.max_attempts:
                    raise
                time.sleep(delay)
                delay *= self.backoff_mult


@dataclasses.dataclass
class _Op:
    kind: str            # "write" | "commit"
    label: object        # step id this op belongs to
    path: str = ""       # write: destination file
    data: bytes = b""
    tmp: str = ""        # commit: staging dir renamed to final
    final: str = ""
    after: object = None  # commit: callback run post-rename (e.g. GC)


_STOP = object()


class AsyncBlobWriter:
    """Bounded-queue background writer with per-step commit semantics.

    Usage (one step)::

        writer.begin_step(step)              # blocks if 2 steps in flight
        writer.put_write(step, path, data)   # as blobs become ready
        ...
        writer.put_write(step, marker_path, b"")   # commit marker last
        writer.put_commit(step, tmp_dir, final_dir, after=gc_fn)

    ``in_flight()`` exposes the registered-but-not-yet-committed steps so
    GC never deletes a directory the worker still owns.
    """

    def __init__(self, fs=None, max_pending_steps: int = 2, retry=None):
        self._fs = fs if fs is not None else HostFS()
        self._retry = retry if retry is not None else RetryPolicy()
        self.max_pending_steps = max_pending_steps
        self._q: queue.Queue = queue.Queue()
        self._cv = threading.Condition()
        self._inflight: list = []      # labels begun, not committed/failed
        self._failed: set = set()      # labels whose remaining ops we drop
        self._pending_ops = 0
        self._error: AsyncWriteError | None = None
        self._dead: BaseException | None = None  # SimulatedCrash/fatal
        self._closed = False
        self.writes = 0
        self.commits = 0
        self.blocked_s = 0.0           # cumulative enqueue backpressure
        self.last_blocked_s = 0.0      # backpressure of the latest begin
        self._thread = threading.Thread(
            target=self._run, name="async-blob-writer", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ producer

    def _raise_pending_locked(self):
        if self._dead is not None:
            raise self._dead
        if self._error is not None:
            err, self._error = self._error, None  # surfaced once, cleared
            raise err

    def check_error(self):
        """Raise (and clear) any pending background failure."""
        with self._cv:
            self._raise_pending_locked()

    def begin_step(self, label) -> float:
        """Register a step; block while ``max_pending_steps`` are already
        in flight (the double-buffer bound).  Returns seconds blocked."""
        t0 = time.monotonic()
        with self._cv:
            self._raise_pending_locked()
            if self._closed:
                raise RuntimeError("AsyncBlobWriter is closed")
            while (
                len(self._inflight) >= self.max_pending_steps
                and self._dead is None
                and self._error is None
            ):
                self._cv.wait(0.05)
            self._raise_pending_locked()
            self._inflight.append(label)
            blocked = time.monotonic() - t0
            self.blocked_s += blocked
            self.last_blocked_s = blocked
            return blocked

    def put_write(self, label, path: str, data) -> None:
        # only a dead worker raises here: OSError-class failures surface at
        # the deterministic points (next begin_step / wait_until_finished),
        # never mid-enqueue — the worker already drops the rest of a failed
        # step's ops, so enqueueing on is harmless
        with self._cv:
            if self._dead is not None:
                raise self._dead
            self._pending_ops += 1
        self._q.put(_Op("write", label, path=path, data=bytes(data)))

    def put_commit(self, label, tmp: str, final: str, after=None) -> None:
        with self._cv:
            if self._dead is not None:
                raise self._dead
            self._pending_ops += 1
        self._q.put(_Op("commit", label, tmp=tmp, final=final, after=after))

    def in_flight(self) -> set:
        with self._cv:
            return set(self._inflight)

    def wait_until_finished(self) -> None:
        """Block until every queued op has been processed; raise any
        pending failure.  Never hangs on a dead worker: a simulated crash
        re-raises immediately."""
        with self._cv:
            while self._pending_ops > 0 and self._dead is None:
                self._cv.wait(0.05)
            self._raise_pending_locked()

    def stats(self) -> dict:
        with self._cv:
            return {
                "writes": self.writes,
                "commits": self.commits,
                "pending_ops": self._pending_ops,
                "in_flight_steps": len(self._inflight),
                "blocked_s": self.blocked_s,
                "last_blocked_s": self.last_blocked_s,
                "alive": self._dead is None,
            }

    def close(self, wait: bool = True) -> None:
        if wait:
            self.wait_until_finished()
        with self._cv:
            self._closed = True
        self._q.put(_STOP)
        self._thread.join(timeout=10.0)

    # ------------------------------------------------------------- worker

    def _finish_op(self, op, failed: BaseException | None = None):
        with self._cv:
            self._pending_ops -= 1
            if failed is not None:
                if self._error is None:  # first failure wins the report
                    self._error = AsyncWriteError(
                        op.label, op.path or op.tmp, failed
                    )
                self._failed.add(op.label)
                if op.label in self._inflight:
                    self._inflight.remove(op.label)
            elif op.kind == "commit" and op.label in self._inflight:
                self._inflight.remove(op.label)
            self._cv.notify_all()

    def _run(self):
        while True:
            op = self._q.get()
            if op is _STOP:
                return
            if op.label in self._failed:
                # the step already failed: drop its remaining ops so the
                # tmp dir is never renamed (never restorable)
                self._finish_op(op)
                continue
            try:
                if op.kind == "write":
                    self._retry.run(lambda: self._fs.write_bytes(op.path, op.data))
                    self.writes += 1
                else:

                    def _commit():
                        # re-saving an existing step replaces it, exactly
                        # like the sync path
                        if self._fs.exists(op.final):
                            self._fs.rmtree(op.final)
                        self._fs.rename(op.tmp, op.final)

                    self._retry.run(_commit)
                    self.commits += 1
            except SimulatedCrash as exc:
                # process death: stop dead, no bookkeeping beyond the flag
                with self._cv:
                    self._dead = exc
                    self._cv.notify_all()
                return
            except BaseException as exc:
                self._finish_op(op, failed=exc)
                continue
            if op.kind == "commit" and op.after is not None:
                # run BEFORE _finish_op so wait_until_finished() cannot
                # return while this callback (GC) is still mutating disk
                try:
                    op.after()
                except SimulatedCrash as exc:
                    with self._cv:
                        self._dead = exc
                        self._cv.notify_all()
                    return
                except Exception:
                    # GC/debris callbacks are best-effort; a failure there
                    # must not poison the committed step
                    pass
            self._finish_op(op)
