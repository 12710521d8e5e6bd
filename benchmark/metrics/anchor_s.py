"""K1/K2 anchoring (core/sml.py, ops/merops.py, ops/matchops.py): seconds per job inside MauveAligner.find_mums, a span the harness records around the call."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    return mean_of(ctx, ["span.find_mums"])
