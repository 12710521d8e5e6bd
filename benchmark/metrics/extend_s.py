"""The host's maximal extension of the K2 anchors (ops/matchops.extend_matches_maximal): seconds per job in every program span named k2_extend, at any depth."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    names = sorted({k for p in ctx["phases"] for k in p
                    if k == "k2_extend" or k.endswith("/k2_extend")})
    return mean_of(ctx, names) if names else None
