"""The K3 kernels' share of their roofline (csrc/gotoh.cu through
ops/gotoh_cuda.py), in percent: the least time an H100 needs for the
profiled job's DP work (roofline.launches_bound_s over the job's recorded
launch shapes, counted from the DP problems' own lengths) over the device
time of the kernels named below in that job's trace."""

from benchmark import roofline

KERNELS = ("gotoh_forward_codes_kernel", "gotoh_forward_profiles_kernel",
           "gotoh_traceback_kernel")


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["launch_shapes"]:
        return None
    device_s = sum(s for name, s in tr["device_ops"] if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    return 100.0 * roofline.launches_bound_s(tr["launch_shapes"]) / device_s
