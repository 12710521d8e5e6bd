"""The K4 HMM and backbone (ops/hmm.py, analysis/backbone.py): the program's phase homology_backbone, seconds per job."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    return mean_of(ctx, ["homology_backbone"])
