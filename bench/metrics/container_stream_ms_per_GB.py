"""Containers layer: the stream time of the outermost container stages
(spans ``lossy.*`` and ``entropy.*`` whose parent is neither) in the traced
window, in milliseconds per GB (1e9) of field bytes.  It counts stages, not
kernel names, so the host API's pack and unpack kernels fall outside it."""

from bench import spans

prepare = spans.prepare


def snapshot(run):
    return spans.snapshot(run, __name__)


def read(run, variant):
    if variant != run.direction or not run.calls:
        return None
    return spans.per_gb(run, spans.stream_ms(run, outermost=spans.CONTAINERS))
