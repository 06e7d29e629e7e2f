"""Field bytes over container bytes, summed over every call of the window:
the bytes users store.  Write cells only."""


def read(run):
    if run.direction != "write" or not run.calls:
        return None
    return run.field_bytes() / run.stored_bytes()
