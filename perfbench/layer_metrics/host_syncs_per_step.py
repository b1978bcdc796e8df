"""`<cell>.host_syncs_per_step`: the host syncs the program counted in its
spans (`host_syncs`, every span, sweeps included) per traced step. Reads 0
on the CPU, where nothing syncs a card."""

from perfbench import program_spans


def read(trace, ctx):
    c = program_spans.counters()
    if c is None:
        return None
    return sum(v.get("host_syncs", 0) for v in c.values()) / trace.counters["steps"]
