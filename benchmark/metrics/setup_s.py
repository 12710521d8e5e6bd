"""Seconds from the start of run.py to the first timed job: imports, CUDA start, loading both built libraries, making and writing the genomes and the warm job."""


def read(ctx):
    return ctx["setup_s"]
