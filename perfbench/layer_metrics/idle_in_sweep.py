"""`<cell>.idle_in_sweep`: the card's idle time while the host was inside
the occupancy sweep (the program's spans train.sweep, occupancy.query and
occupancy.finish), as a share of the traced window
(perfbench/program_spans.py)."""

from perfbench import program_spans


def read(trace, ctx):
    return program_spans.idle_share(trace, "train.sweep", "occupancy.query",
                                    "occupancy.finish")
