"""Field bytes restored in the window over the summed wall time of the
decompress calls (host clock, each call until the bytes are on the host),
in GB/s (1e9 bytes).  Read cells only."""


def read(run):
    if run.direction != "read" or not run.calls:
        return None
    return run.field_bytes() / run.call_seconds() / 1e9
