"""`<cell>.fused_mlp_roofline`: the fused MLP kernel's share of its roofline
in the traced steps. The least time of the work the inputs need (each
step's sigma and colour calls on the samples it shaded, each sweep's sigma
calls on its points) over the device time of the kernels named
fused_mlp_kernel."""

from perfbench import roofline


def read(trace, ctx):
    busy = trace.device_seconds("fused_mlp_kernel")
    if busy <= 0:
        return None
    _, bound = roofline.flops_and_bound(trace.counters, ctx.config)
    return 100.0 * bound / busy
