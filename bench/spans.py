"""The program's own spans and counters (``repro_torch.runtime.trace``), for
the per-layer readers that read them (``bench/metrics/``).

Those readers share three hooks, each idempotent over the readers:
``prepare(run)``, in the traced run's set-up after the warm-up, turns the
tracer on; ``snapshot(run, reader)`` at the window's start zeroes it, and
at the window's end (after the harness's synchronise) takes its snapshot
once and turns it off.  Untraced runs load none of this, so the
end-to-end runs have tracing off.  A program without the tracer leaves
every reading ``None``.

``idle_split(run)`` puts each idle gap of the window (``Trace.gaps()``)
down to the program span open over it: each part of a gap goes to the
innermost span of ``trace.SPANS`` open over that part (the spans appear in
the device trace as ``user_annotation`` events), or to no span, which is
between calls, the harness's time.
"""

from __future__ import annotations

KEY = "bench.spans"
API = ("lzss.", "pipeline.")
CONTAINERS = ("lossy.", "entropy.")
COPIES = ("lzss.h2d", "lzss.d2h")


def _state(run) -> dict:
    st = run.prepared.get(KEY)
    if st is None:
        try:
            from repro_torch.runtime import trace
        except ImportError:
            trace = None
        st = run.prepared[KEY] = {"trace": trace, "zeroed": False, "final": None, "idle": None}
    return st


def prepare(run) -> None:
    st = _state(run)
    if st["trace"] is not None:
        st["trace"].enable()


def snapshot(run, reader: str) -> None:
    """``reader`` is the calling module's ``__name__``: the harness files a
    reader's start snapshot under it, so its presence marks the end."""
    st = _state(run)
    trace = st["trace"]
    if trace is None:
        return None
    if reader not in run.snapshots:  # the window's start
        if not st["zeroed"]:
            trace.reset()
            st["zeroed"] = True
    elif st["final"] is None:  # the window's end
        st["final"] = trace.snapshot()
        trace.disable()
    return None


def final(run):
    """The tracer's snapshot at the window's end, or ``None``."""
    return _state(run)["final"]


def stream_ms(run, names=None, outermost=None):
    """Summed stream time of the window's spans named in ``names`` or, with
    ``outermost`` (name prefixes), of the spans with such a name whose parent
    has none; ``None`` where no such span has a stream time."""
    snap = final(run)
    if snap is None:
        return None
    spans = snap["spans"]
    if outermost is not None:
        name_of = {s["id"]: s["name"] for s in spans}
        picked = [s for s in spans if s["name"].startswith(outermost)
                  and not name_of.get(s["parent"], "").startswith(outermost)]
    else:
        picked = [s for s in spans if s["name"] in names]
    times = [s["stream_ms"] for s in picked if s["stream_ms"] is not None]
    return sum(times) if times else None


def innermost_segments(spans) -> list:
    """``(start, end, name)`` pieces of time, in order, over which one span
    of ``spans`` (``devtrace.Event``, nested) is the innermost open one;
    ``name`` is ``None`` where none is open."""
    bounds = sorted({t for s in spans for t in (s.start, s.end)})
    order = sorted(spans, key=lambda s: (s.start, -s.end))
    out, stack, i = [], [], 0
    for t0, t1 in zip(bounds, bounds[1:]):
        while stack and stack[-1].end <= t0:
            stack.pop()
        while i < len(order) and order[i].start <= t0:
            s = order[i]
            i += 1
            while stack and stack[-1].end <= s.start:
                stack.pop()
            if s.end > t0:
                stack.append(s)
        out.append((t0, t1, stack[-1].name if stack else None))
    return out


def split_gaps(gaps, segments) -> dict:
    """Seconds of ``gaps`` ((start, end) us, in order) under each name of
    ``segments`` (``innermost_segments``, contiguous); time outside them
    goes to ``None``."""
    out = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(segments) and segments[j][1] <= g0:
            j += 1
        covered = 0.0
        k = j
        while k < len(segments) and segments[k][0] < g1:
            a, b = max(g0, segments[k][0]), min(g1, segments[k][1])
            if b > a:
                out[segments[k][2]] = out.get(segments[k][2], 0.0) + (b - a) * 1e-6
                covered += b - a
            k += 1
        if g1 - g0 > covered:
            out[None] = out.get(None, 0.0) + (g1 - g0 - covered) * 1e-6
    return out


def idle_split(run):
    """``{span name or None: idle seconds}`` of the traced window, or
    ``None`` where the trace holds no device activity or no program span.
    Logs, once a run, the stream time and idle of each stage and the sum
    the three parts must make."""
    st = _state(run)
    if st["idle"] is not None:
        return st["idle"] or None
    st["idle"] = {}
    t = run.devtrace
    if st["trace"] is None or t is None or not run.calls or not t.in_window():
        return None
    names = set(st["trace"].SPANS)
    lo, hi = t.window
    spans = [e for e in t.host if e.name in names and e.end > lo and e.start < hi]
    if not spans:
        return None
    gaps = t.gaps()
    split = dict.fromkeys(sorted({e.name for e in spans}), 0.0)  # every span that ran
    for k, v in split_gaps(gaps, innermost_segments(spans)).items():
        split[k] = split.get(k, 0.0) + v
    st["idle"] = split
    total = sum(g1 - g0 for g0, g1 in gaps) * 1e-6
    api = sum(v for k, v in split.items() if k and k.startswith(API))
    cont = sum(v for k, v in split.items() if k and k.startswith(CONTAINERS))
    outside = split.get(None, 0.0)
    snap = st["final"] or {"stages": {}}
    for name in sorted(set(snap["stages"]) | {k for k in split if k}):
        stage = snap["stages"].get(name, {})
        run.log(f"spans: {name}: {stage.get('count', 0)} spans, host "
                f"{stage.get('host_ms', 0.0):.3f} ms, stream {stage.get('stream_ms')} ms, "
                f"idle {split.get(name, 0.0) * 1e3:.3f} ms")
    run.log(f"spans: idle host API {api:.6f} s + containers {cont:.6f} s + outside any "
            f"program span {outside:.6f} s = {api + cont + outside:.6f} s; device idle of "
            f"the window {total:.6f} s ({100.0 * (api + cont + outside - total) / max(total, 1e-12):+.4f}%)")
    return split


def per_gb(run, ms):
    return None if ms is None else ms / (run.field_bytes() / 1e9)
