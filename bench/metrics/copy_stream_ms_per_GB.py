"""Host API layer: the stream time of the program's copy spans
(``lzss.h2d``, ``lzss.d2h``: a CUDA event pair each, the copy's work on the
card and any stream idle between its first and last operation) in the
traced window, in milliseconds per GB (1e9) of field bytes.  The
in-program measure of what ``copy_ms_per_GB`` times by memcpy name."""

from bench import spans

prepare = spans.prepare


def snapshot(run):
    return spans.snapshot(run, __name__)


def read(run, variant):
    if variant != run.direction or not run.calls:
        return None
    return spans.per_gb(run, spans.stream_ms(run, names=spans.COPIES))
