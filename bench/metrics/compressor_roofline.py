"""Kernels layer: the one-launch compressor's own roofline share.  The
least time the chip needs for the window's calls, counted as
``kernels_roofline`` counts it (``bench/roofline.py``: the field and the
container each moved once, and the window walk's compares on each call's
symbols, counted once an item in the traced set-up), over the device time
of the program's ``fused_mono`` kernels alone in the window, in percent.

A window with no ``fused_mono`` kernel reads nothing."""

from bench import devtrace, roofline
from bench.metrics import kernels_roofline

KERNEL = "fused_mono"


def prepare(run):
    if kernels_roofline.__name__ not in run.prepared:  # count once, whoever asks first
        kernels_roofline.prepare(run)


def read(run, variant):
    if variant != run.direction or run.devtrace is None or not run.calls:
        return None
    kernel_s = run.devtrace.seconds(
        ("kernel",), lambda n: devtrace.is_program_kernel(n, {KERNEL}))
    if kernel_s <= 0:
        return None
    compares = run.prepared[kernels_roofline.__name__]
    ops = sum(compares[c.item] for c in run.calls) if compares else 0
    nbytes = run.field_bytes() + run.stored_bytes()
    least, by = roofline.least_seconds(nbytes, ops)
    run.log(f"compressor_roofline.{variant}: {nbytes} bytes, {ops} operations, bound by {by}; "
            f"least {least:.6f} s, {KERNEL} {kernel_s:.6f} s")
    return 100.0 * least / kernel_s
