"""The command line's writers (tools/cli.py, core/interval.py, analysis/islands.py): the program's phase outputs, seconds per job."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    return mean_of(ctx, ["outputs"])
