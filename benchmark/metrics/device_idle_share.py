"""The device's idle share over the profiled job: 1 - busy / the job's wall, where a device's busy time is the union of its device intervals (kernels, copies, sets).  On several devices busy is the mean device's (trace.reduce_events), so this reads the mean chip's idle share."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
