"""Mean seconds per window job of a sum of host spans (the program's
timing.GLOBAL phases, and the harness's own spans as "span.<name>")."""


def mean_of(ctx, names):
    per_job = ctx["phases"]
    if not per_job or not any(n in p for p in per_job for n in names):
        return None
    return sum(sum(p.get(n, 0.0) for n in names) for p in per_job) / len(per_job)
