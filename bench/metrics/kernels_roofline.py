"""Kernels layer: the least time the chip needs for the window's calls
(``bench/roofline.py``: the field and the container each moved once and,
in a write whose configuration names ``window_walk_compares``, the
compares of a greedy window walk on the bytes each call compresses) over
the device time of every kernel in the window, the program's and
PyTorch's alike, in percent.

An item's bytes are the flat slices its op says it compresses
(``op.item_fields(i)``, each a buffer of its own chunks), by default the
item's row of the fields."""

import torch

from bench import roofline


def item_fields(run, i) -> list:
    hook = getattr(run.op, "item_fields", None)
    return hook(i) if hook is not None else [run.program_fields[i]]


def prepare(run):
    """Count each item's compares once, in the traced run's set-up."""
    if run.config.get("roofline_ops") != "window_walk_compares" or run.direction != "write":
        run.prepared[__name__] = None
        return
    codec = run.config["codec"]
    s, c = codec["symbol_size"], codec["chunk_symbols"]
    run.prepared[__name__] = [
        roofline.window_walk_compares(
            torch.cat([roofline.symbols(f, s, c) for f in item_fields(run, i)]), codec["window"])
        for i in range(len(run.op))
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
