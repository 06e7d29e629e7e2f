"""Fault tolerance: step guard (straggler detection), restart policy,
heartbeats, and the injectable filesystem seam the crash-consistency
harness drives.

The port's own copy of the reference package's module: pure Python, no
import of ``repro`` (the two packages stay apart at run time).

On a real multi-pod deployment each host runs the training loop under a
``StepGuard``; the coordinator (or GKE/Borg health checks) watches the
heartbeat file.  Recovery is always restart-from-checkpoint: the data
pipeline is a pure function of (seed, step) and checkpoints are mesh-
agnostic, so a restart — even onto a different number of pods (elastic.py) —
reproduces the exact training trajectory from the last saved step.

Filesystem seam (``HostFS`` / ``FaultyFS``): every byte the checkpoint
writers put on disk goes through one of these objects, so tests can inject
EIO/ENOSPC/delays/crash-before-rename at an exact write boundary — the
Nth matching filesystem call — deterministically (per-spec counters) or
seeded-randomly (``FaultSpec.probability``).  ``SimulatedCrash`` derives
from ``BaseException`` on purpose: retry policies and the ``except
Exception`` fallback ladders (e.g. ``restore_latest``) must never swallow
a simulated process death, only the test harness catches it.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import os
import random
import shutil
import time


class SimulatedCrash(BaseException):
    """Process death injected by ``FaultyFS``.

    A ``BaseException`` so no ``except Exception`` recovery path (retry
    policies, ``restore_latest``'s walk-back) can accidentally absorb it:
    the crash must propagate to the test harness exactly like a real
    SIGKILL would leave the disk — partial bytes, no cleanup.
    """

    def __init__(self, op: str, path: str):
        super().__init__(f"simulated crash during {op}({path})")
        self.op = op
        self.path = path


class HostFS:
    """Real-filesystem backend of the write seam.

    Checkpoint/blob writers call these instead of ``open``/``os.rename``
    directly so ``FaultyFS`` can interpose.  The surface is deliberately
    tiny: exactly the operations whose failure order matters for crash
    consistency.
    """

    def write_bytes(self, path: str, data) -> None:
        with open(path, "wb") as f:
            f.write(data)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def rename(self, src: str, dst: str) -> None:
        os.rename(src, dst)

    def makedirs(self, path: str, exist_ok: bool = False) -> None:
        os.makedirs(path, exist_ok=exist_ok)

    def rmtree(self, path: str, ignore_errors: bool = False) -> None:
        shutil.rmtree(path, ignore_errors=ignore_errors)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def listdir(self, path: str):
        return os.listdir(path)


@dataclasses.dataclass
class FaultSpec:
    """One injected failure: trigger on the ``nth``..``nth+count-1``-th
    call (1-based, counted per spec over *matching* calls) of ``op``
    whose path contains ``path_substr``.

    mode:
      * ``"error"`` — raise ``OSError(error, ...)`` (EIO default;
        ``count`` bounds it, so transient-then-success is
        ``count=2`` + a retrying writer);
      * ``"delay"`` — sleep ``delay_s`` then succeed (slow-disk model,
        used to force writer backpressure deterministically);
      * ``"crash"`` — flush ``partial`` of the bytes (writes only), then
        raise ``SimulatedCrash``: the process "died" at this boundary.

    ``probability`` > 0 switches the spec from counter-triggered to
    seeded-random: each matching call fires with that probability from
    the owning ``FaultyFS``'s ``random.Random(seed)`` — identical seeds
    replay identical fault sequences.
    """

    op: str = "write"          # "write" | "rename" | "makedirs" | "rmtree" | "*"
    nth: int = 1
    count: int = 1
    error: int = errno.EIO
    mode: str = "error"        # "error" | "delay" | "crash"
    delay_s: float = 0.0
    partial: float = 0.0
    path_substr: str = ""
    probability: float = 0.0
    hits: int = 0              # times this spec actually fired (observable)
    _seen: int = 0             # matching calls observed (internal counter)


class FaultyFS(HostFS):
    """Deterministic, seedable fault injection over the ``HostFS`` seam.

    Every instrumented call is appended to ``self.log`` as ``(op, path)``
    even when no fault fires, so tests can *enumerate* a save's write
    boundaries from a clean run and then replay with a crash planted at
    each one.  ``calls`` counts per-op totals (retry-attempt assertions).
    """

    _OPS = ("write", "rename", "makedirs", "rmtree")

    def __init__(self, faults=(), seed: int = 0):
        self.faults = list(faults)
        self.seed = seed
        self._rng = random.Random(seed)
        self.calls = {op: 0 for op in self._OPS}
        self.log: list = []

    def _fire(self, f: FaultSpec, op: str, path: str, data=None):
        f.hits += 1
        if f.mode == "delay":
            time.sleep(f.delay_s)
            return
        if f.mode == "crash":
            if op == "write" and data is not None and f.partial > 0:
                n = int(len(data) * f.partial)
                super().write_bytes(path, bytes(data[:n]))
            raise SimulatedCrash(op, path)
        raise OSError(f.error, os.strerror(f.error), path)

    def _check(self, op: str, path: str, data=None):
        self.calls[op] += 1
        self.log.append((op, path))
        for f in self.faults:
            if f.op != "*" and f.op != op:
                continue
            if f.path_substr and f.path_substr not in path:
                continue
            f._seen += 1
            if f.probability > 0.0:
                if self._rng.random() < f.probability:
                    self._fire(f, op, path, data)
            elif f.nth <= f._seen < f.nth + f.count:
                self._fire(f, op, path, data)

    def write_bytes(self, path, data):
        self._check("write", path, data)
        super().write_bytes(path, data)

    def rename(self, src, dst):
        self._check("rename", src)
        super().rename(src, dst)

    def makedirs(self, path, exist_ok=False):
        self._check("makedirs", path)
        super().makedirs(path, exist_ok=exist_ok)

    def rmtree(self, path, ignore_errors=False):
        self._check("rmtree", path)
        super().rmtree(path, ignore_errors=ignore_errors)


@dataclasses.dataclass
class StragglerStats:
    steps: int = 0
    slow_steps: int = 0
    mean_s: float = 0.0
    worst_s: float = 0.0
    # async-writer backpressure: wall-clock the loop spent blocked on
    # checkpoint I/O (enqueue waits / sync write time), tracked as its own
    # axis so a slow disk is never misread as a slow accelerator step
    io_wait_steps: int = 0
    io_wait_s: float = 0.0
    io_stalls: int = 0


class StepGuard:
    """Wall-clock watchdog around train steps.

    * keeps an EWMA of step time; a step slower than ``threshold`` x EWMA is
      flagged (straggler signal — on real fleets this triggers hot-spare
      swap-in / slice reconfiguration);
    * after ``max_consecutive_slow`` flags, ``should_restart`` turns True and
      the launcher falls back to checkpoint-restart;
    * async-checkpoint-writer backpressure (``io_wait_s``: time the loop
      spent blocked handing a step to ``runtime/async_io.AsyncBlobWriter``)
      is accounted as its OWN straggler axis — an ``io_stall`` when the
      wait exceeds the step-time EWMA — and never feeds the compute EWMA
      or ``should_restart``: a slow disk wants throttled checkpoint
      cadence, not a checkpoint-restart.
    """

    def __init__(self, threshold: float = 3.0, max_consecutive_slow: int = 3,
                 heartbeat_path: str = ""):
        self.threshold = threshold
        self.max_slow = max_consecutive_slow
        self.heartbeat_path = heartbeat_path
        self.ewma = None
        self.consecutive_slow = 0
        self.stats = StragglerStats()

    def observe(self, step: int, seconds: float,
                io_wait_s: float = 0.0) -> bool:
        """Record one step; returns True if the step was a straggler.

        ``seconds`` is pure step compute (excludes checkpoint I/O, as the
        train loop times it); ``io_wait_s`` is how long the loop blocked on
        checkpoint writes since the previous observe — the async writer's
        enqueue backpressure, or the full write time in sync mode.
        """
        self.stats.steps += 1
        self.stats.worst_s = max(self.stats.worst_s, seconds)
        self.stats.mean_s += (seconds - self.stats.mean_s) / self.stats.steps
        if io_wait_s > 0.0:
            self.stats.io_wait_steps += 1
            self.stats.io_wait_s += io_wait_s
            if self.ewma is not None and io_wait_s > self.ewma:
                # the loop lost more than a whole step's compute waiting on
                # the writer: the disk, not a device, is the straggler
                self.stats.io_stalls += 1
        slow = False
        if self.ewma is not None and seconds > self.threshold * self.ewma:
            slow = True
            self.consecutive_slow += 1
            self.stats.slow_steps += 1
        else:
            self.consecutive_slow = 0
        a = 0.1
        self.ewma = seconds if self.ewma is None else (
            (1 - a) * self.ewma + a * seconds
        )
        if self.heartbeat_path:
            tmp = self.heartbeat_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "t": time.time(),
                           "step_s": seconds, "io_wait_s": io_wait_s,
                           "io_stalls": self.stats.io_stalls}, f)
            os.replace(tmp, self.heartbeat_path)
        return slow

    @property
    def io_stalled(self) -> bool:
        return self.stats.io_stalls > 0

    @property
    def should_restart(self) -> bool:
        return self.consecutive_slow >= self.max_slow


def run_with_restarts(make_loop, max_restarts: int = 2):
    """Supervisor: run ``make_loop()`` (which resumes from the latest
    checkpoint internally); on exception, restart up to ``max_restarts``."""
    attempt = 0
    while True:
        try:
            return make_loop()
        except Exception as exc:
            attempt += 1
            if attempt > max_restarts:
                raise
            print(f"[fault] loop failed ({exc!r}); restart {attempt}/"
                  f"{max_restarts} from latest checkpoint")
