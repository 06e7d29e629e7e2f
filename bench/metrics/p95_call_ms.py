"""Host API layer: the 95th percentile of the traced window's API calls,
in milliseconds, as ``bench/e2e/p95_call_ms.py`` takes it.  The per-layer
home of the tail in cells whose tail spreads too widely from run to run
to hold to a bound; the profiler's cost is in these calls."""

from bench.e2e.p95_call_ms import p95_ms


def read(run, variant):
    if variant != run.direction or not run.calls:
        return None
    return p95_ms(run)
