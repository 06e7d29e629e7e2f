"""Host API layer: the places the host waits for the card's stream in the
traced window (the counter ``host_syncs`` of ``repro_torch.runtime.trace``:
card-to-host reads and pageable host-to-card copies), per call."""

from bench import spans

prepare = spans.prepare


def snapshot(run):
    return spans.snapshot(run, __name__)


def read(run, variant):
    snap = spans.final(run)
    if variant != run.direction or snap is None or not run.calls:
        return None
    return snap["counters"]["host_syncs"] / len(run.calls)
