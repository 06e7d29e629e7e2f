"""The 95th percentile of the wall times of all the window's API calls, in
milliseconds (nearest rank: the ceil(0.95 n)-th shortest of n calls)."""

import math


def p95_ms(run):
    t = sorted(c.end - c.start for c in run.calls)
    rank = math.ceil(0.95 * len(t))
    run.log(f"p95_call_ms: {len(t)} calls, {len(t) - rank} beyond the 95th percentile")
    return t[rank - 1] * 1e3


def read(run):
    return p95_ms(run) if run.calls else None
