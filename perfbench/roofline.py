"""Peaks of the card and the operations and bytes the field's work needs.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its 700 W limit
(dense, without sparsity); the harness prints the card's power limit beside
every run, since a card set below it reaches less.

Counts follow the inputs, not what the program pads to: a fused-MLP call on
n rows of widths D_0..D_L reads each input once and writes each output once
in float32 and reads its bf16 weights once; its operations are 2 n sum(D_i
D_i+1). A training step's MLP operations are three times the forward's
(the forward, and the products for the input and the weight gradients).
"""

H100_BF16_FLOP_PER_S = 989e12
H100_BYTES_PER_S = 3.35e12


def mlp_flops(n: float, dims) -> float:
    return 2.0 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def mlp_bytes(n: float, dims, weight_bytes: int = 2) -> float:
    return n * (dims[0] + dims[-1]) * 4 + sum(a * b * weight_bytes
                                              for a, b in zip(dims[:-1], dims[1:]))


def mlp_bound_s(n: float, dims) -> float:
    """Least time of one fused-MLP call on n rows: the larger of its bytes
    over the peak bandwidth and its operations over the bf16 peak."""
    if n <= 0:
        return 0.0
    return max(mlp_bytes(n, dims) / H100_BYTES_PER_S, mlp_flops(n, dims) / H100_BF16_FLOP_PER_S)


def field_flops(samples: float, c, backward: bool) -> float:
    """MLP operations of the field (sigma and colour nets) on `samples`
    points, times three for a training step."""
    f = mlp_flops(samples, c["sigma_net"]) + mlp_flops(samples, c["color_net"])
    return 3.0 * f if backward else f


def sweep_flops(points: float, c) -> float:
    """MLP operations of a density sweep: the sigma net alone."""
    return mlp_flops(points, c["sigma_net"])


def flops_and_bound(counters, c, backward=True):
    """(MLP operations, least fused-MLP seconds) of a traced sub-window's
    steps and sweeps, from the samples each step shaded and the points each
    sweep queried (in chunks of the sweep's chunk size)."""
    flops = sum(field_flops(k, c, backward) for k in counters["samples"])
    bound = sum(mlp_bound_s(k, c["sigma_net"]) + mlp_bound_s(k, c["color_net"])
                for k in counters["samples"])
    chunk = counters["sweep_chunk"]
    for pts in counters["sweep_points"]:
        flops += sweep_flops(pts, c)
        full, rest = divmod(pts, chunk)
        bound += full * mlp_bound_s(chunk, c["sigma_net"])
        bound += mlp_bound_s(rest, c["sigma_net"])
    return flops, bound
