"""``filt_host_us.block``: the host's time in a call of ``FIRFilter.filt``
(the API's and the block step's host work and the kernel's launch), in
microseconds: the mean ``mr.api.filt`` span of the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_us(run, "mr.api.filt")
