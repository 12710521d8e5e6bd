"""Sensitivity of the aligned position pairs against the simulation truth, pooled over every (genome 0, genome i) pair: truth-aligned pairs that the XMFA aligns to the same signed position."""


def read(ctx):
    return ctx["report"].get("aligned_sn")
