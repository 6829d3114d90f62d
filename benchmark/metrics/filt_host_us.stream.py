"""``filt_host_us.stream``: the host's time in ``FIRFilter.filt`` for a
block of the stream (the API's and the block step's host work and the
kernel's launch), in microseconds: the mean ``mr.api.filt`` span under a
``mr.stream.block`` span in the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_us(run, "mr.api.filt", "mr.stream.block")
