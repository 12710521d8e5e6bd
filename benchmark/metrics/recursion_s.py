"""LCB extension and recursive anchoring (models/aligner.py over ops/matchops.py): the program's phases lcb_extension and recursive_anchoring, seconds per job."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    return mean_of(ctx, ["lcb_extension", "recursive_anchoring"])
