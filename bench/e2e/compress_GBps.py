"""Field bytes compressed in the window over the summed wall time of the
compress calls (host clock, each call until the container is on the
host), in GB/s (1e9 bytes).  Write cells only."""


def read(run):
    if run.direction != "write" or not run.calls:
        return None
    return run.field_bytes() / run.call_seconds() / 1e9
