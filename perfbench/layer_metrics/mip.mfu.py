"""`mip.mfu`: the traced steps' share of the card's bf16 peak: three times
the forward operations of mip-NeRF's MLP on the samples the program counted
(`mlp_samples` of its render.coarse and render.fine spans) over the traced
window."""

from perfbench import program_spans, roofline_mip


def read(trace, ctx):
    samples = roofline_mip.mlp_samples(program_spans.counters())
    if trace.window_s <= 0 or not trace.kernels or not samples:
        return None
    flops = 3.0 * roofline_mip.forward_flops(samples, ctx.config)
    return 100.0 * flops / trace.window_s / roofline_mip.H100_BF16_FLOP_PER_S
