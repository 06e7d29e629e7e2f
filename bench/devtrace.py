"""The device trace of a run's window, read from ``torch.profiler``.

The profiler records host operations and the card's kernels, copies and
memsets (CUPTI); the trace is exported as Chrome trace JSON into a
temporary directory (``TMPDIR``) and read back into plain lists.  The
window is the span from the first timed call's start to the last one's
end, as the harness marks them with ``record_function`` spans.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


@dataclasses.dataclass
class Event:
    name: str
    start: float  # microseconds, the trace's clock
    end: float
    kind: str = "host"  # host, kernel, memcpy or memset


@dataclasses.dataclass
class Trace:
    device: list
    host: list
    window: tuple  # (start, end) microseconds

    @property
    def window_s(self) -> float:
        return max(0.0, self.window[1] - self.window[0]) * 1e-6

    def in_window(self, kinds=("kernel", "memcpy", "memset")) -> list:
        """Device events of ``kinds`` clipped to the window."""
        lo, hi = self.window
        out = []
        for e in self.device:
            if e.kind in kinds and e.end > lo and e.start < hi:
                out.append(Event(e.name, max(e.start, lo), min(e.end, hi), e.kind))
        return out

    def seconds(self, kinds=("kernel",), name=None) -> float:
        """Summed device seconds of the window's events of ``kinds`` whose
        name passes ``name`` (a predicate; ``None``: every name)."""
        return 1e-6 * sum(
            e.end - e.start for e in self.in_window(kinds) if name is None or name(e.name)
        )

    def busy(self) -> list:
        """The window's device activity as merged (start, end) intervals."""
        spans = sorted((e.start, e.end) for e in self.in_window())
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return 1e-6 * sum(e - s for s, e in self.busy())

    def gaps(self) -> list:
        """(start, end) of every stretch of the window with no device activity."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host operation open at ``t``, or ``host``."""
        best = None
        for e in self.host:
            if e.start <= t < e.end and (best is None or e.start >= best.start):
                best = e
        return best.name if best is not None else "host"

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each named by the host operation open at its start."""
        by_name = {}
        for e in self.in_window():
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {
            "device_ops": [[name, s] for name, s in ops],
            "idle_gaps": [[self.host_at(s), (e - s) * 1e-6] for s, e in gaps],
        }


def from_events(events: list, span: str) -> Trace:
    """A ``Trace`` from Chrome trace events; the window spans the host
    annotations named ``span``."""
    device, host, marks = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        e = Event(ev.get("name", ""), float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        if cat in DEVICE_CATS:
            e.kind = DEVICE_CATS[cat]
            device.append(e)
        elif cat in HOST_CATS:
            host.append(e)
            if cat == "user_annotation" and e.name == span:
                marks.append(e)
    window = (min(m.start for m in marks), max(m.end for m in marks)) if marks else (0.0, 0.0)
    return Trace(device=device, host=host, window=window)


def from_profiler(prof, span: str) -> Trace:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return from_events(events, span)


def profiler(device: str):
    """A ``torch.profiler.profile`` of the host and, for a run on the card,
    the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def copy_direction(name: str):
    """``HtoD``, ``DtoH``, ``DtoD`` or ``None`` from a memcpy's name."""
    m = re.search(r"\b([HDP])to([HDP])\b", name)
    return f"{m.group(1)}to{m.group(2)}" if m else None


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def program_kernels(package: str = "repro_torch") -> set:
    """Names of the ``__global__`` functions in the program's CUDA sources
    (``<package>/csrc``); the kernel names are the program's."""
    import importlib.util
    import pathlib

    spec = importlib.util.find_spec(package)
    names = set()
    for root in spec.submodule_search_locations or ():
        for src in sorted(pathlib.Path(root, "csrc").glob("*.cu*")):
            names.update(_GLOBAL.findall(src.read_text()))
    return names


def kernel_identity(name: str) -> tuple:
    """(namespace, identifier) of a demangled kernel name, e.g.
    ``void (anonymous namespace)::decode<true, 2>(...)`` ->
    (``(anonymous namespace)``, ``decode``)."""
    anon = "(anonymous namespace)"
    n = name.strip().replace(anon, "\0")
    if n.startswith("void "):
        n = n[5:]
    q = re.split(r"[<(]", n, maxsplit=1)[0].strip()
    ns, _, ident = q.rpartition("::")
    return ns.replace("\0", anon), ident


def is_program_kernel(name: str, kernels: set) -> bool:
    ns, ident = kernel_identity(name)
    return ident in kernels and ns in ("", "(anonymous namespace)")
