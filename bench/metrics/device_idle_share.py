"""Device layer: the share of the traced window in which the card runs
neither a kernel nor a copy nor a memset, in percent."""


def read(run, variant):
    if variant != run.direction or run.devtrace is None or not run.calls:
        return None
    t = run.devtrace
    if t.window_s <= 0 or not t.in_window():
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
