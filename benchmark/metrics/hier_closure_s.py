"""The hierarchical closure (models/closure.hierarchical_align_region_groups past its pairwise fast path): seconds per job in every program span named cl_hier, at any depth."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    names = sorted({k for p in ctx["phases"] for k in p
                    if k == "cl_hier" or k.endswith("/cl_hier")})
    return mean_of(ctx, names) if names else None
