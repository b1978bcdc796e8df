"""`<cell>.kernels_per_step`: kernel launches per step in the traced steps
(copies and fills not counted), sweeps included."""


def read(trace, ctx):
    n = trace.kernels and trace.n_kernels()
    return n / trace.counters["steps"] if n else None
