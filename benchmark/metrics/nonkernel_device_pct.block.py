"""``nonkernel_device_pct.block``: the share of the device's busy time in
the traced window spent in operations other than the filter kernels
(``polyphase``, ``resample``): the history's copies, casts, fills and
allocations of ``ops/compute.py`` and ``ops/api.py``, in %."""


def read(run):
    if run.trace is None:
        return None
    total = run.trace.device_s()
    if not total:
        return None
    kernels = run.trace.device_s("polyphase") + run.trace.device_s("resample")
    return 100.0 * (total - kernels) / total
