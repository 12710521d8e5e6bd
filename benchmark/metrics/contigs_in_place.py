"""Share of the draft's contigs that sortContigs puts in their true order and strand."""


def read(ctx):
    return ctx["report"].get("contigs_in_place")
