"""Host API layer: device-side copy time between host and card (HtoD and
DtoH memcpys, pageable or pinned, from the profiler's CUDA activity) in
the traced window, in milliseconds per GB (1e9) of field bytes."""

from bench import devtrace


def read(run, variant):
    if variant != run.direction or run.devtrace is None or not run.calls:
        return None
    if not run.devtrace.in_window(("kernel", "memcpy", "memset")):
        return None
    s = run.devtrace.seconds(
        ("memcpy",), lambda n: devtrace.copy_direction(n) in ("HtoD", "DtoH"))
    return s * 1e3 / (run.field_bytes() / 1e9)
