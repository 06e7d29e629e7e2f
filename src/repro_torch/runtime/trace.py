"""The port's spans and counters: one tracer, off by default.

    from repro_torch.runtime import trace

    trace.enable()
    blob = lzss.compress(field, cfg)          # any host-API calls
    snap = trace.snapshot()                   # counters, per-stage times, spans
    trace.export("spans.json")                # beside a torch.profiler trace
    trace.disable()

A span (``span(name, **attrs)``, a context manager) records its name, its
start and end on ``time.perf_counter_ns``, its own id, its parent span's id
and a call id that every span of one top-level API call shares.  Spans go
into a bounded buffer in memory (``MAX_SPANS``); the ones a full buffer
cannot keep are counted under ``dropped``.  Nothing is written out until
``snapshot`` or ``export`` is called.

With tracing on, three things more happen:

  * while ``torch.profiler`` runs, each span is also opened as a
    ``record_function`` of the same name, so it appears in the profiler's
    trace as a ``user_annotation`` on the trace's own clock, nested as the
    spans are;
  * the spans of ``DEVICE_STAGES`` given a CUDA ``device`` record a
    ``torch.cuda.Event`` pair on that device's current stream at enter and
    exit; the pair's elapsed time (the "stream time": the stage's work on
    the card and any stream idle between its first and last operation) is
    read in ``snapshot``, after the caller's own synchronise, and never
    waited for;
  * ``export`` writes the spans as Chrome trace JSON on the clock of
    ``torch.profiler``'s export: ``baseTimeNanoseconds`` plus ``ts``
    microseconds is Unix time in nanoseconds (``enable`` takes one
    (``time.time_ns``, ``time.perf_counter_ns``) anchor pair).

``count(name, n)`` adds to one of ``COUNTERS``, each counting what its site
asks for, whatever the device, so that a run on the CPU counts what the
same path counts on the card:

  ``bytes_h2d``        bytes a site asks to move host -> card
  ``bytes_d2h``        bytes a site asks to move card -> host
  ``bytes_host_copy``  whole-buffer copies the program makes in host memory
  ``host_syncs``       each place the host waits for the card's stream: a
                       card -> host read (``.cpu()``, ``int(tensor)``,
                       ``torch.nonzero``'s size) or a blocking host -> card
                       copy
  ``pinned_bytes``     bytes a site stages through page-locked blocks of
                       torch's caching host allocator
  ``pinned_allocs``    blocks that allocator had to allocate for them (the
                       rise of ``torch.cuda.host_memory_stats()``'s
                       ``num_host_alloc``; 0 where its cache held one)
  ``rows_packed_alone`` buffers of a batch that ``compress_many``'s pack
                       copied one at a time: a ragged batch, whose buffers
                       neither fill their rows nor share one length
  ``symbol_bytes``     bytes of the int32 symbol rows the host API's pack
                       writes for the compressor: 4 a padded symbol, so
                       4 / S a field byte

With tracing off, ``span`` returns one shared no-op context and ``count``
returns at once: the cost is a flag check a site.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _profiler

SPANS = (
    # host API (core/lzss.py): the four roots, then the stages inside them
    "lzss.compress",
    "lzss.decompress",
    "lzss.compress_many",
    "lzss.decompress_many",
    "lzss.validate",
    "lzss.h2d",
    "lzss.pack",
    "lzss.dispatch",
    "lzss.decode",
    "lzss.unpack",
    "lzss.d2h",
    # pipeline (core/pipeline.py): the device-to-host read of section totals
    "pipeline.totals",
    # containers (core/lossy.py, core/entropy.py); lossy.inner and
    # entropy.lz are the inner lossless stage in both directions
    "lossy.quantize",
    "lossy.bitshuffle",
    "lossy.inner",
    "lossy.outliers",
    "lossy.assemble",
    "lossy.unshuffle",
    "lossy.dequantize",
    "entropy.lz",
    "entropy.histogram",
    "entropy.code_lengths",
    "entropy.encode",
    "entropy.assemble",
    "entropy.gap_decode",
    "entropy.gather",
)
COUNTERS = ("bytes_h2d", "bytes_d2h", "bytes_host_copy", "host_syncs", "pinned_bytes",
            "pinned_allocs", "rows_packed_alone", "symbol_bytes", "dropped")
# timed on the stream as well as on the host clock: the container stages
# and the host API's copies
DEVICE_STAGES = frozenset(
    [n for n in SPANS if n.startswith(("lossy.", "entropy."))] + ["lzss.h2d", "lzss.d2h"]
)
MAX_SPANS = 1 << 18

_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_spans: list = []
_counts = dict.fromkeys(COUNTERS, 0)
_anchor = None  # (time.time_ns(), time.perf_counter_ns()) at enable()


class _NoSpan:
    """The shared context ``span`` returns with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NOOP = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "device", "id", "parent", "call", "tid", "start", "end",
                 "events", "mirror", "stream_ms")

    def __init__(self, name, device, attrs):
        self.name, self.device, self.attrs = name, device, attrs
        self.events = self.mirror = self.stream_ms = None

    def set(self, **attrs):
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.call = parent.call if parent is not None else self.id
        self.tid = threading.get_ident()
        stack.append(self)
        if self.device is not None and self.name in DEVICE_STAGES:
            dev = torch.device(self.device)
            if dev.type == "cuda":
                stream = torch.cuda.current_stream(dev)
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record(stream)
        # the clock is read outside the mirror: a profiler's first annotation
        # can take a millisecond to open
        self.start = time.perf_counter_ns()
        if _profiler._is_profiler_enabled:
            self.mirror = torch.profiler.record_function(self.name)
            self.mirror.__enter__()
        return self

    def __exit__(self, *exc):
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
            self.mirror = None
        self.end = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(torch.device(self.device)))
        _stack().pop()  # ``with`` blocks close innermost first
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(self)
            else:
                _counts["dropped"] += 1
        return False


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn tracing on and take the anchor pair ``export`` converts with."""
    global _on, _anchor
    _anchor = (time.time_ns(), time.perf_counter_ns())
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drop the kept spans and zero the counters (spans still open are
    kept when they close)."""
    with _lock:
        _spans.clear()
        for k in COUNTERS:
            _counts[k] = 0


def span(name: str, device=None, **attrs):
    """A span named ``name`` (one of ``SPANS``) around a ``with`` block;
    ``device`` gives a stage of ``DEVICE_STAGES`` its stream."""
    if not _on:
        return _NOOP
    return _Span(name, device, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of ``COUNTERS``)."""
    if not _on:
        return
    with _lock:
        _counts[name] += n


def _resolve(spans) -> None:
    """Stream times of the spans whose second event has completed."""
    for s in spans:
        if s.events is not None and s.events[1].query():
            s.stream_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None


def snapshot() -> dict:
    """What the tracer holds, as plain data:

      ``counters``  every counter of ``COUNTERS``, and the port's kernel
                    launches (``ops.launch_counts()``) as ``launches.<kernel>``
      ``stages``    per span name: ``count``, ``host_ms`` (summed duration)
                    and ``stream_ms`` (summed stream time, ``None`` where no
                    span of the name has one)
      ``spans``     one dict a kept span: ``name``, ``id``, ``parent``,
                    ``call``, ``tid``, ``start_ns``, ``end_ns``,
                    ``stream_ms``, ``attrs``
    """
    from repro_torch.kernels import ops

    with _lock:
        spans = list(_spans)
        counters = dict(_counts)
    _resolve(spans)
    counters.update({f"launches.{k}": v for k, v in ops.launch_counts().items()})
    stages = {}
    for s in spans:
        st = stages.setdefault(s.name, {"count": 0, "host_ms": 0.0, "stream_ms": None})
        st["count"] += 1
        st["host_ms"] += (s.end - s.start) * 1e-6
        if s.stream_ms is not None:
            st["stream_ms"] = (st["stream_ms"] or 0.0) + s.stream_ms
    return {
        "counters": counters,
        "stages": stages,
        "spans": [
            {"name": s.name, "id": s.id, "parent": s.parent, "call": s.call, "tid": s.tid,
             "start_ns": s.start, "end_ns": s.end, "stream_ms": s.stream_ms,
             "attrs": dict(s.attrs)}
            for s in spans
        ],
    }


def export(path) -> None:
    """Write the kept spans to ``path`` as Chrome trace JSON, on the clock
    of ``torch.profiler``'s export (``baseTimeNanoseconds`` + ``ts`` us is
    Unix time in ns), so that both files load side by side in one viewer.
    The counters go under the top-level key ``counters``."""
    snap = snapshot()
    wall, perf = _anchor if _anchor is not None else (time.time_ns(), time.perf_counter_ns())
    base = wall - wall % 1_000_000_000
    pid = os.getpid()
    events = [
        {"ph": "X", "cat": "repro_torch", "name": s["name"], "pid": pid, "tid": s["tid"],
         "ts": (wall + s["start_ns"] - perf - base) / 1e3,
         "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
         "args": {"id": s["id"], "parent": s["parent"], "call": s["call"],
                  "stream_ms": s["stream_ms"], **s["attrs"]}}
        for s in snap["spans"]
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base,
                   "displayTimeUnit": "ms", "counters": snap["counters"]}, f)
