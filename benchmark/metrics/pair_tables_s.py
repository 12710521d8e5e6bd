"""The sharded pair search's sharded part (parallel.sharded.find_pair_mums_sharded): every shard's unique-MUM candidate search over its pairs, the capacity retries and the read of the run counts; seconds per job in every program span named pair_tables, at any depth."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    names = sorted({k for p in ctx["phases"] for k in p
                    if k == "pair_tables" or k.endswith("/pair_tables")})
    return mean_of(ctx, names) if names else None
