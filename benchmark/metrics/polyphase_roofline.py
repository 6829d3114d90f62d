"""``polyphase_roofline``: the rational polyphase kernel's share of its
roofline (``csrc/polyphase.cu``), in %.

The least time of the traced window's calls (``work.least_seconds`` of each
call's bytes and multiply-adds, from shapes) over the summed device time of
the kernels whose name holds ``polyphase`` in the profiler's trace.
"""


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.device_s("polyphase")
    return 100.0 * run.counters["least_s"] / kernel_s if kernel_s else None
