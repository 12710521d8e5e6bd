"""The sharded pair search's unshared part (parallel.sharded.find_pair_mums_sharded): the reference's and every draft's mer lists and the padded pair tables, all built on one device before the shards split the pairs; seconds per job in every program span named pair_sml, at any depth."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    names = sorted({k for p in ctx["phases"] for k in p
                    if k == "pair_sml" or k.endswith("/pair_sml")})
    return mean_of(ctx, names) if names else None
