"""The tree ladder (models/tree_progressive.py): the program's phase tree_progressive, seconds per job."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    return mean_of(ctx, ["tree_progressive"])
