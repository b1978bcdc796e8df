"""`<cell>.sweep_share`: the occupancy sweeps' share of the traced steps.
The harness's spans around the `Trainer._maybe_update_occupancy` calls that
swept, over the traced window."""


def read(trace, ctx):
    swept = ctx.spans.total("sweep", trace.counters["t0"], trace.counters["t1"])
    return 100.0 * swept / trace.window_s if swept > 0 else None
