"""The XMFA writer (core/interval.IntervalList.write_xmfa): the program's span outputs/xmfa, seconds per job."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    return mean_of(ctx, ["outputs/xmfa"])
