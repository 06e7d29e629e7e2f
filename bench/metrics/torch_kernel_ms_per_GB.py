"""Containers layer: device time of the kernels that are not the
program's own CUDA kernels (PyTorch's packing, padding, elementwise and
scan kernels; the program's are the ``__global__`` functions of
``repro_torch/csrc``) in the traced window, in milliseconds per GB (1e9)
of field bytes."""

from bench import devtrace


def prepare(run):
    run.prepared[__name__] = devtrace.program_kernels()


def read(run, variant):
    if variant != run.direction or run.devtrace is None or not run.calls:
        return None
    if not run.devtrace.in_window(("kernel",)):
        return None
    own = run.prepared[__name__]
    s = run.devtrace.seconds(("kernel",), lambda n: not devtrace.is_program_kernel(n, own))
    return s * 1e3 / (run.field_bytes() / 1e9)
