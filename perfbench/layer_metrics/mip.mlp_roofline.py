"""`mip.mlp_roofline`: mip-NeRF's MLP's share of its roofline in the traced
steps: the least time of the training work on the samples the program
counted (`mlp_samples`; roofline_mip.train_bound_s) over the device time of
the matmul kernels (cuBLAS nvjet / xmma GEMMs, CUTLASS, gemv, and split-K
reduces; roofline_mip.is_gemm). Every GEMM of the step is the MLP's."""

from perfbench import program_spans, roofline_mip


def read(trace, ctx):
    samples = roofline_mip.mlp_samples(program_spans.counters())
    busy = roofline_mip.gemm_seconds(trace)
    if busy <= 0 or not samples:
        return None
    return 100.0 * roofline_mip.train_bound_s(samples, ctx.config) / busy
