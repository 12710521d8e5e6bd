"""The per-draft host work of sortContigs over several drafts: each draft's LCB determination and contig placement; seconds per job in every program span named lcb_determination or placement, at any depth."""

SPANS = ("lcb_determination", "placement")


def read(ctx):
    from benchmark.metrics._phases import mean_of

    names = sorted({k for p in ctx["phases"] for k in p
                    if k.split("/")[-1] in SPANS})
    return mean_of(ctx, names) if names else None
