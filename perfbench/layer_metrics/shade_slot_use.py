"""`<cell>.shade_slot_use`: the share of the shade's slots that held a
valid sample in the traced steps: the program's render.shade counters,
100 x filled_slots / shaded_slots (filled: min(valid samples, slots) each
step; shaded: the point budget where the packed shade ran, else N x K)."""

from perfbench import program_spans


def read(trace, ctx):
    shade = (program_spans.counters() or {}).get("render.shade", {})
    if not shade.get("shaded_slots"):
        return None
    return 100.0 * shade["filled_slots"] / shade["shaded_slots"]
