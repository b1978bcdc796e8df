"""`mip.idle_in_resample`: the card's idle time while the host was inside
the program's span render.resample (and no span inside it), as a share of
the traced window (perfbench/program_spans.py)."""

from perfbench import program_spans


def read(trace, ctx):
    return program_spans.idle_share(trace, "render.resample")
