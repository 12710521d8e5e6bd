"""Seconds a user waits for one job: the sum of the window's job walls over the number of its jobs (each job from its start to its end, which includes torch.cuda.synchronize())."""


def read(ctx):
    return ctx["job_s"]
