"""``comm_device_pct.sharded``: the share of rank 0's traced window that
its card spent in NCCL's kernels (the halo's sends and receives, the
history's broadcast), in %."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * run.trace.device_s("nccl") / run.trace.window_s
