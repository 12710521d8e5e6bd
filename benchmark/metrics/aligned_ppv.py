"""Positive predictive value of the aligned position pairs against the simulation truth, pooled over every (genome 0, genome i) pair."""


def read(ctx):
    return ctx["report"].get("aligned_ppv")
