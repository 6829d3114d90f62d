"""``resample_roofline``: the arbitrary/Farrow resample kernel's share of its
roofline (``csrc/resample.cu``), in %.

The least time of the traced window's calls (``work.least_seconds``; a
Farrow output's multiply-adds are T * (P + C)) over the summed device time
of the kernels whose name holds ``resample`` in the profiler's trace.
"""


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.device_s("resample")
    return 100.0 * run.counters["least_s"] / kernel_s if kernel_s else None
