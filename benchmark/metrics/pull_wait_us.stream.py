"""``pull_wait_us.stream``: the host's time in a pull's copy to host memory
(the wait for the device and the copy into pageable memory), in
microseconds: the mean ``mr.stream.to_host`` span of the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_us(run, "mr.stream.to_host")
