"""Host API layer: the bytes of the int32 symbol rows the program's pack
writes for the compressor in the traced window (the counter
``symbol_bytes`` of ``repro_torch.runtime.trace``), over the window's field
bytes: 4 / S where every call packs whole chunks, so 4.00 at S=1.

A program without the counter reads nothing."""

from bench import spans

prepare = spans.prepare


def snapshot(run):
    return spans.snapshot(run, __name__)


def read(run, variant):
    snap = spans.final(run)
    if variant != run.direction or snap is None or not run.calls:
        return None
    n = snap["counters"].get("symbol_bytes")
    return None if n is None else n / run.field_bytes()
