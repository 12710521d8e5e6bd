"""The program outside its spans: the mean over window jobs of the job's wall less the seconds of the program's top-level spans (keys with no "/"; the harness's own "span.<name>" are left out)."""


def read(ctx):
    tops = [{k: t for k, t in p.items() if "/" not in k and not k.startswith("span.")}
            for p in ctx["phases"]]
    if not any(tops):
        return None
    return ctx["job_s"] - sum(sum(t.values()) for t in tops) / len(tops)
