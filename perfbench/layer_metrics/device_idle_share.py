"""`<cell>.device_idle_share`: the card's idle share in the traced window,
1 - (the union of the kernels' intervals) / (the traced window)."""


def read(trace, ctx):
    if trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
