"""`<cell>.mfu`: the traced steps' share of the card's bf16 peak. The MLP
operations the steps' inputs need (three times the forward's on the samples
each step shaded, plus the sweeps' sigma net on every queried point) over
the traced window."""

from perfbench import roofline


def read(trace, ctx):
    if trace.window_s <= 0 or not trace.kernels:
        return None
    flops, _ = roofline.flops_and_bound(trace.counters, ctx.config)
    return 100.0 * flops / trace.window_s / roofline.H100_BF16_FLOP_PER_S
