"""Host API layer: the bytes the program asks to copy in the traced window,
host to card, card to host and within host memory (the counters
``bytes_h2d`` + ``bytes_d2h`` + ``bytes_host_copy`` of
``repro_torch.runtime.trace``), over the window's field bytes."""

from bench import spans

prepare = spans.prepare


def snapshot(run):
    return spans.snapshot(run, __name__)


def read(run, variant):
    snap = spans.final(run)
    if variant != run.direction or snap is None or not run.calls:
        return None
    c = snap["counters"]
    return (c["bytes_h2d"] + c["bytes_d2h"] + c["bytes_host_copy"]) / run.field_bytes()
