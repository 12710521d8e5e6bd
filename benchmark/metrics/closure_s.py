"""The K3 closure (models/closure.py, ops/dp.py): the program's phase gapped_closure, seconds per job."""


def read(ctx):
    from benchmark.metrics._phases import mean_of

    return mean_of(ctx, ["gapped_closure"])
