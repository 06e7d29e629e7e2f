"""Pipeline and wrappers layer: the program's own count of its CUDA kernel
launches (``repro_torch.kernels.ops.launch_counts()``), its change over
the window divided by the window's calls."""


def snapshot(run):
    from repro_torch.kernels import ops

    return sum(ops.launch_counts().values())


def read(run, variant):
    if variant != run.direction or not run.calls:
        return None
    before, after = run.snapshots[__name__]
    return (after - before) / len(run.calls)
