"""Seconds from the process's start to the first timed call: importing,
loading or building the kernels, making the fields, the operation's
set-up and the warm-up of every item."""


def read(run):
    return run.setup_s
