"""``launch_us.block``: the host's time in a kernel wrapper's launch (the
alignment check, ``plan``, the output's allocation and the ctypes call),
in microseconds: the mean ``mr.kernel.launch`` span of the traced
window."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_us(run, "mr.kernel.launch")
