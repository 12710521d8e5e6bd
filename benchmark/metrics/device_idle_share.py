"""The device's idle share over the profiled job: 1 - the union of its device intervals (kernels, copies, sets) over the job's wall."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
