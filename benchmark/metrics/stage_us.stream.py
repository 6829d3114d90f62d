"""``stage_us.stream``: the host's time to stage a block of the stream for
the device (``torch.from_numpy``, ``pin_memory()`` and the non-blocking
copy), in microseconds: the mean ``mr.stream.stage`` span of the traced
window."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_us(run, "mr.stream.stage")
