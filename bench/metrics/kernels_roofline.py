"""Kernels layer: the least time the chip needs for the window's calls
(``bench/roofline.py``: the field and the container each moved once and,
in a write whose configuration names ``window_walk_compares``, the
compares of a greedy window walk on each call's field) over the device
time of every kernel in the window, the program's and PyTorch's alike, in
percent."""

from bench import roofline


def prepare(run):
    """Count each field's compares once, in the traced run's set-up."""
    if run.config.get("roofline_ops") != "window_walk_compares" or run.direction != "write":
        run.prepared[__name__] = None
        return
    codec = run.config["codec"]
    run.prepared[__name__] = [
        roofline.window_walk_compares(
            roofline.symbols(f, codec["symbol_size"], codec["chunk_symbols"]), codec["window"])
        for f in run.program_fields
    ]


def read(run, variant):
    if variant != run.direction or run.devtrace is None or not run.calls:
        return None
    kernel_s = run.devtrace.seconds(("kernel",))
    if kernel_s <= 0:
        return None
    compares = run.prepared[__name__]
    ops = sum(compares[c.item] for c in run.calls) if compares else 0
    nbytes = run.field_bytes() + run.stored_bytes()
    least, by = roofline.least_seconds(nbytes, ops)
    run.log(f"kernels_roofline.{variant}: {nbytes} bytes, {ops} operations, bound by {by} "
            f"at HBM {roofline.HBM_BW:.4g} B/s and {roofline.INT32_OPS:.4g} int32 op/s; "
            f"least {least:.6f} s, kernels {kernel_s:.6f} s")
    return 100.0 * least / kernel_s
