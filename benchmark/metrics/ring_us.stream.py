"""``ring_us.stream``: the host's time in the native ring for each block of
the stream, in microseconds: the summed ``mr.stream.ring_push`` and
``mr.stream.ring_pop`` spans of the traced window (every push and every
pop, most of which find no block) over its count of ``mr.stream.block``
spans."""

from benchmark import program_spans


def read(run):
    spans = program_spans.of(run)
    if not spans:
        return None
    blocks = sum(1 for s in spans if s[0] == "mr.stream.block")
    ring = program_spans.durations_us(spans, "mr.stream.ring_push") + \
        program_spans.durations_us(spans, "mr.stream.ring_pop")
    return sum(ring) / blocks if blocks and ring else None
