"""Refinement (models/refine.py, analysis/sp.py): the program's phase refinement, seconds per job."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    return mean_of(ctx, ["refinement"])
