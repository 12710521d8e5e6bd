"""The hierarchical closure's host count profiles (models/closure._profiles_of_many): seconds per job in every program span named cl_hier_profiles, at any depth."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    names = sorted({k for p in ctx["phases"] for k in p
                    if k == "cl_hier_profiles" or k.endswith("/cl_hier_profiles")})
    return mean_of(ctx, names) if names else None
