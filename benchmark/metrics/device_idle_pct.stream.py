"""``device_idle_pct.stream``: the share of the traced window in which no
kernel, copy or fill ran on the device, in %, in the stream cells."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
