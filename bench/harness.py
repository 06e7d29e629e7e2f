"""One run of one cell: set-up, the measured window, the check, the result.

The run makes the cell's fields from the seed on the device, hands them to
the operation the traffic mix names (``bench/ops/<op>.py``), warms every
item up, and then calls the program in a closed loop with one client for
``seconds`` seconds, cycling through the items.  Each call is timed on the
host clock from its start to the return of the API, which hands its result
to the host.  One kept result an item, drawn from the seed, is checked
after the window against the plain reference (``bench/reference/``).
With ``trace`` the window runs under ``torch.profiler``, ends after the
traffic's ``traced_cycles`` cycles if that comes first, and the per-layer
readers (``bench/metrics/``) read the device trace; without it the
end-to-end readers (``bench/e2e/``) read the calls.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import math
import random
import subprocess
import sys
import time
import traceback

import torch

from bench import devtrace, manifest

SPAN = "bench.call"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (``name`` may hold ``-``
    and ``.``, as manifest names do)."""
    if not manifest.NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = manifest.BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path.relative_to(manifest.ROOT)}")
    mod_name = f"bench.{kind}.{name.replace('.', '__').replace('-', '_')}"
    mod = sys.modules.get(mod_name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Call:
    item: int
    start: float
    end: float
    field_bytes: int
    stored_bytes: int


@dataclasses.dataclass
class Run:
    """What a reader sees of a run."""

    manifest: dict
    cell: dict
    config: dict
    traffic: dict
    device: str
    fields: torch.Tensor = None  # (items, n) uint8, as the seed makes them
    program_fields: torch.Tensor = None  # what the program is handed
    guarantee: object = None
    op: object = None
    calls: list = dataclasses.field(default_factory=list)
    failed: int = 0
    setup_s: float = 0.0
    snapshots: dict = dataclasses.field(default_factory=dict)
    devtrace: object = None
    prepared: dict = dataclasses.field(default_factory=dict)

    log = staticmethod(log)

    @property
    def direction(self) -> str:
        return self.op.direction

    def field_bytes(self) -> int:
        return sum(c.field_bytes for c in self.calls)

    def stored_bytes(self) -> int:
        return sum(c.stored_bytes for c in self.calls)

    def call_seconds(self) -> float:
        return sum(c.end - c.start for c in self.calls)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _family(metric_name: str) -> tuple:
    family, _, variant = metric_name.partition(".")
    return family, variant


def run_cell(man: dict, cell_name: str, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False, started=None, config=None,
             traffic=None):
    """One run; returns ``(result dict, checks)``, ``checks`` a list of
    ``(name, value, limit)``.  ``started`` is the process's start on the
    ``time.perf_counter`` clock (set-up is measured from it); ``config``
    and ``traffic`` replace the cell's configuration and traffic mix (the
    tests' small sizes)."""
    started = time.perf_counter() if started is None else started
    cell = manifest.cell(man, cell_name)
    cfg = config if config is not None else manifest.config(man, cell["config"])
    traffic = traffic if traffic is not None else manifest.traffic(cell["traffic"])
    run = Run(manifest=man, cell=cell, config=cfg, traffic=traffic, device=device)
    if (run.traffic.get("loop"), run.traffic.get("clients")) != ("closed", 1):
        raise ValueError("the harness drives one client in a closed loop; "
                         f"traffic {cell['traffic']!r} asks for another")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # ---- set-up: the fields, the operation's own set-up, a warm-up of every item
    gen = load_module("gen", cfg["data"]["generator"])
    run.fields = gen.make(cfg["data"], seed, device)
    run.guarantee = load_module("reference", cfg["guarantee"]["kind"])
    run.program_fields = run.fields
    if control:
        run.program_fields = run.guarantee.control(
            run.fields, cfg["guarantee"], cfg["codec"]["symbol_size"])
    op_mod = load_module("ops", run.traffic["op"])
    run.op = op_mod.Op(run)
    n_items = len(run.op)
    for _ in range(run.traffic.get("warmup_cycles", 1)):
        for i in range(n_items):
            run.op.call(i)
    metrics = manifest.reported(man, cell_name, trace)
    readers = {}
    for m in metrics:
        kind, fam = ("metrics", _family(m["name"])[0]) if trace else ("e2e", m["name"])
        readers[m["name"]] = load_module(kind, fam)
    hooks = {id(r): r for r in readers.values()}.values()
    for r in hooks:
        if hasattr(r, "prepare"):
            r.prepare(run)
    _sync(device)

    # ---- the window: one client in a closed loop, cycling through the items
    rng = random.Random(seed)
    kept, seen = {}, [0] * n_items
    # the profiler's events, and the time to read them, grow with the calls it
    # sees: a traffic mix may end a traced window after ``traced_cycles``
    max_calls = run.traffic.get("traced_cycles", math.inf) * n_items if trace else math.inf
    prof = devtrace.profiler(device) if trace else contextlib.nullcontext()
    with prof:
        for r in hooks:
            if hasattr(r, "snapshot"):
                run.snapshots[r.__name__] = [r.snapshot(run)]
        run.setup_s = time.perf_counter() - started
        t_end = time.perf_counter() + seconds
        k = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end or k >= max_calls:
                break
            item = k % n_items
            k += 1
            try:
                with torch.profiler.record_function(SPAN) if trace else contextlib.nullcontext():
                    out = run.op.call(item)
                t1 = time.perf_counter()
            except Exception:  # a failed call counts, and the loop goes on
                if not run.failed:
                    log(traceback.format_exc())
                run.failed += 1
                continue
            fb, sb = run.op.sizes(item, out)
            run.calls.append(Call(item, t0, t1, fb, sb))
            seen[item] += 1
            if rng.randrange(seen[item]) == 0:  # one kept call an item, uniform
                kept[item] = run.op.kept(out)
            del out
        _sync(device)
        window_closed = time.perf_counter()
        for r in hooks:
            if hasattr(r, "snapshot"):
                run.snapshots[r.__name__].append(r.snapshot(run))
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    if trace:
        run.devtrace = devtrace.from_profiler(prof, SPAN)

    # ---- the check, once the program's state is freed
    run.op.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    rows = run.op.check(kept)
    limits = {**getattr(op_mod, "LIMITS", {}), **run.guarantee.LIMITS}
    values = {}
    for row in rows:
        for name, v in row.items():
            if name.startswith("max_"):
                values[name] = max(values.get(name, -math.inf), v)
            else:
                values[name] = values.get(name, 0) + v
    checks = [(name, values.get(name, 0), lim) for name, lim in limits.items()]
    log(f"checked {len(kept)} kept calls of {n_items} items in "
        f"{time.perf_counter() - t_check:.3f} s")

    # ---- the result
    out_metrics = {}
    for m in metrics:
        r = readers[m["name"]]
        v = r.read(run, _family(m["name"])[1]) if trace else r.read(run)
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name() if torch.device(device).type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": len(run.calls) + run.failed, "failed": run.failed,
              "metrics": out_metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.devtrace.busy_s()
        dev["window_s"] = run.devtrace.window_s
        result["breakdown"] = run.devtrace.breakdown()
    passed = all(v <= lim for _, v, lim in checks)  # a NaN fails
    result["correct"] = bool(passed and run.calls and kept and not run.failed)
    log(f"card: {_card_line()}; window {window_closed - t_end + seconds:.3f} s, "
        f"{len(run.calls)} calls, {run.failed} failed, {run.field_bytes()} field bytes, "
        f"{run.stored_bytes()} stored bytes")
    return result, checks


def forbidden_modules() -> list:
    """Modules loaded whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None, started=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="hand the program the control's data (bench/reference/)")
    args = ap.parse_args(argv)
    man = manifest.load()
    chips = int(manifest.cell(man, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    result, checks = run_cell(man, args.workload, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), control=bool(args.control),
                              started=started)
    bad = forbidden_modules()
    if bad:
        log(f"the process loaded {bad}: the benchmark runs the port alone")
        return 3
    for name, v, lim in checks:
        log(f"check {name} {v} limit {lim}")
    result["checks"] = {name: {"value": v if math.isfinite(v) else None, "limit": lim}
                        for name, v, lim in checks}
    print(json.dumps(result), flush=True)
    return 0
