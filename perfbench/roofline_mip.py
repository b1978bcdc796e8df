"""Operations and bytes of mip-NeRF's MLP, for the readers of the
mipnerf-train-blender cell. The peaks are roofline.py's.

The MLP of a configuration is `layer_dims`' layers on each sample of both
levels. Its forward takes 2 sum(in x out) operations a sample (1,220,608 at
the published widths); a training step adds the products for each weight's
gradient and for each layer's input gradient but the first layer's (its
input, the encoding, takes none). Its least bytes are the work's inputs
and outputs once: a sample's encoding read and its 4 outputs written in
float32 and their gradients read, and the weights read in bf16 and their
gradients written in float32; what a fused MLP keeps on the chip is not
counted. At these widths operations bound it.
"""

from perfbench.roofline import H100_BF16_FLOP_PER_S, H100_BYTES_PER_S

# device kernels that are a matmul's: cuBLAS's nvjet and xmma GEMMs, CUTLASS
# kernels and gemv; a split-K GEMM's second kernel reduces its partial sums
GEMM_NAMES = ("nvjet", "gemm", "gemv", "cutlass")
SPLIT_K_REDUCE = "splitkreduce"


def layer_dims(c) -> dict:
    """(in, out) of every layer, by the program's params key."""
    pos = 6 * (c["max_deg_point"] - c["min_deg_point"])
    w, dims, d_in = c["net_width"], [], pos
    for i in range(c["net_depth"]):
        dims.append((d_in, w))
        d_in = w + pos if i % c["skip_layer"] == 0 and i > 0 else w
    return {"trunk": dims, "sigma": [(d_in, 1)], "bottleneck": [(d_in, w)],
            "view": [(w + 3 + 6 * c["deg_view"], c["net_width_condition"])],
            "rgb": [(c["net_width_condition"], 3)]}


def _products(c) -> int:
    return sum(a * b for layers in layer_dims(c).values() for a, b in layers)


def forward_flops(samples: float, c) -> float:
    return 2.0 * samples * _products(c)


def train_flops(samples: float, c) -> float:
    first_in, first_out = layer_dims(c)["trunk"][0]
    return 2.0 * samples * (3 * _products(c) - first_in * first_out)


def train_bytes(samples: float, c) -> float:
    pos = layer_dims(c)["trunk"][0][0]
    return samples * (pos + 4 + 4) * 4 + _products(c) * (2 + 4)


def train_bound_s(samples: float, c) -> float:
    """Least time of the MLP's training work on `samples` samples."""
    return max(train_flops(samples, c) / H100_BF16_FLOP_PER_S,
               train_bytes(samples, c) / H100_BYTES_PER_S)


def matmuls_per_level(c) -> int:
    """Matmuls the program launches a level and step: every layer's
    forward and weight gradient, the input gradients of all but the first
    trunk layer and the density head (one product per entry,
    elementwise)."""
    n = sum(len(layers) for layers in layer_dims(c).values())
    return 3 * n - 2


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in GEMM_NAMES) or SPLIT_K_REDUCE in low


def gemm_seconds(trace) -> float:
    return sum(e - s for n, s, e in trace.kernels if is_gemm(n)) / 1e9


def gemm_launches(trace) -> int:
    """Matmul launches: GEMM kernels, a split-K GEMM's reduce not counted."""
    return sum(1 for n, _, _ in trace.kernels
               if is_gemm(n) and SPLIT_K_REDUCE not in n.lower())


def mlp_samples(counters) -> int:
    """The samples the program's MLP shaded, summed over its spans."""
    return sum(v.get("mlp_samples", 0) for v in (counters or {}).values())
