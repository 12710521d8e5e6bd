"""Peak device memory of the window's jobs: torch.cuda.max_memory_allocated() after a reset at the window's start, in GiB.  On several devices each is reset and read, and this is the fullest device's."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx["peak_bytes"] else None
