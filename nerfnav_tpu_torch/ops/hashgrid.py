"""Multiresolution hash-grid encoding (Instant-NGP), differentiable.

Counterpart of nerfnav_tpu/ops/hashgrid.py: the same level schedule, table
layouts ("corner": one F-wide row per lattice vertex, 8 gathers per point and
level; "cell": one 8F-wide row per cell, 1 gather), lattice conventions
("vertex", "ngp"), out-of-bounds zeroing and bf16 table compute.

Index math runs in int64 and is cut to 32 bits after every product, so the
hashes match the reference's uint32 arithmetic bit for bit: the primes
exceed int32. The gather is plain torch `index_select`, so autograd gives the
table gradient as an `index_add_` of the weighted output gradients (the
reference's "xla" backward) and dy/dx through the trilinear weights. The
reference's "sort" backward sums the same rows in another order (a sorted
segment sum); the port computes it as "xla" does. With bf16 table compute the
gradient is accumulated in bf16 and cast back to f32 once per table, as in
the reference. Hand kernels for both directions are ROADMAP B2.
"""

from dataclasses import dataclass
from functools import cached_property
import math

import numpy as np
import torch

from nerfnav_tpu_torch.device import device_const, resolve_device

# Spatial hash primes (reference gridencoder.cu:36-51).
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridConfig:
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    desired_resolution: int | None = None  # overrides per_level_scale when set
    gridtype: str = "hash"  # "hash" | "tiled"
    layout: str = "corner"  # "corner" | "cell"
    backward: str = "xla"  # "xla" | "sort": both run the index_add_ gradient
    coord_convention: str = "vertex"  # "vertex" | "ngp"
    table_compute_dtype: str = "float32"  # "float32" | "bfloat16"

    @cached_property
    def scale(self) -> float:
        if self.desired_resolution is not None and self.num_levels > 1:
            return 2.0 ** (
                math.log2(self.desired_resolution / self.base_resolution)
                / (self.num_levels - 1)
            )
        return self.per_level_scale

    @cached_property
    def resolutions(self) -> tuple:
        return tuple(
            int(math.ceil(self.base_resolution * (self.scale**l)))
            for l in range(self.num_levels)
        )

    @cached_property
    def level_sizes(self) -> tuple:
        """Row count per level, 8-aligned: (R+1)^D vertices (corner) or R^D
        cells (cell) when dense, else 2^log2_hashmap_size."""
        max_params = 2**self.log2_hashmap_size
        sizes = []
        for r in self.resolutions:
            dense = (r + 1) ** self.input_dim if self.layout == "corner" else r**self.input_dim
            params = min(max_params, dense)
            sizes.append(int(math.ceil(params / 8) * 8))
        return tuple(sizes)

    @cached_property
    def offsets(self) -> tuple:
        out, acc = [], 0
        for s in self.level_sizes:
            out.append(acc)
            acc += s
        return tuple(out)

    @cached_property
    def total_params(self) -> int:
        return sum(self.level_sizes)

    @cached_property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @cached_property
    def row_dim(self) -> int:
        """Features per table row."""
        if self.layout == "cell":
            return (2**self.input_dim) * self.level_dim
        return self.level_dim


def hash_grid_init(generator, config: HashGridConfig, dtype=torch.float32,
                   device="cuda"):
    """Uniform(-1e-4, 1e-4) tables: a LIST of per-level (size_l, row_dim).

    generator: a CPU torch.Generator (or None); the tables are drawn on the
    CPU and moved to `device`, so a seed gives the same tables everywhere."""
    dev = resolve_device(device)
    return [
        (torch.rand((s, config.row_dim), generator=generator, dtype=torch.float32)
         * 2e-4 - 1e-4).to(device=dev, dtype=dtype)
        for s in config.level_sizes
    ]


def _corner_indices(config: HashGridConfig, level: int, gc: torch.Tensor):
    """Integer corner coords (N, 2^D, D) int64 -> level-table rows (N, 2^D)."""
    r = config.resolutions[level]
    size = config.level_sizes[level]
    stride_fits = (r + 1) ** config.input_dim <= 2**config.log2_hashmap_size
    if config.gridtype == "hash" and not stride_fits:
        idx = (gc[..., 0] * _PRIMES[0]) & _U32
        for d in range(1, config.input_dim):
            idx = idx ^ ((gc[..., d] * _PRIMES[d]) & _U32)
        idx = idx & (2**config.log2_hashmap_size - 1)
    elif config.coord_convention == "ngp":
        # reference dense order: x + y*(R+1) + z*(R+1)^2
        idx = gc[..., config.input_dim - 1]
        for d in range(config.input_dim - 2, -1, -1):
            idx = (idx * (r + 1) + gc[..., d]) & _U32
        if not stride_fits:  # tiled overflow: wrap by modulo
            idx = idx % size
    else:
        idx = gc[..., 0]
        for d in range(1, config.input_dim):
            idx = (idx * (r + 1) + gc[..., d]) & _U32
        if not stride_fits:
            idx = idx % size
    return idx


def _cell_indices(config: HashGridConfig, level: int, gc: torch.Tensor):
    """Integer cell coords (N, D) int64 -> table rows (N,) (cell layout)."""
    r = config.resolutions[level]
    size = config.level_sizes[level]
    dense_fits = r**config.input_dim <= 2**config.log2_hashmap_size
    if config.gridtype == "hash" and not dense_fits:
        idx = (gc[..., 0] * _PRIMES[0]) & _U32
        for d in range(1, config.input_dim):
            idx = idx ^ ((gc[..., d] * _PRIMES[d]) & _U32)
        idx = idx % size
    else:
        idx = gc[..., 0]
        for d in range(1, config.input_dim):
            idx = (idx * r + gc[..., d]) & _U32
        if not dense_fits:
            idx = idx % size
    return idx


def _corner_bits(d: int) -> np.ndarray:
    """(2^D, D) corner offsets; dim 0 is the most significant bit."""
    return np.stack(
        [(np.arange(2**d) >> i) & 1 for i in range(d - 1, -1, -1)], axis=-1
    ).astype(np.float32)


def unit_coords(x: torch.Tensor, bound: float) -> torch.Tensor:
    """(x + bound) / (2 bound) in float32, the same bits on every device.

    The divisor is a tensor on x's device: CUDA divides by a Python scalar as
    a multiply by its reciprocal, which can end a bit off the CPU's quotient
    and so move a point next to a cell face into the next cell at a bound
    that is not a power of two."""
    return (x.float() + bound) / device_const(2.0 * bound, x.device)


def hash_grid_encode(table, x: torch.Tensor, config: HashGridConfig,
                     bound: float = 1.0) -> torch.Tensor:
    """table: list of per-level (size_l, row_dim) tables; x: (N, D) in
    [-bound, bound]. Returns (N, num_levels * level_dim) float32;
    out-of-bounds points get all-zero features."""
    n = x.shape[0]
    d = config.input_dim
    num_corners = 2**d
    x01 = unit_coords(x, bound)
    in_bounds = ((x01 >= 0.0) & (x01 <= 1.0)).all(dim=-1)
    # maximum/minimum, not clamp: like jnp.clip they pass half the gradient
    # at a point exactly on the boundary
    zero = torch.zeros((), device=x.device)
    x01c = torch.minimum(torch.maximum(x01, zero), zero + 1.0)
    bits = torch.as_tensor(_corner_bits(d), device=x.device)
    hi = bits > 0.5

    outs = []
    for level in range(config.num_levels):
        lvl_table = table[level]
        if (config.table_compute_dtype == "bfloat16"
                and lvl_table.dtype == torch.float32):
            lvl_table = lvl_table.to(torch.bfloat16)
        r = config.resolutions[level]
        if config.coord_convention == "ngp":
            scale_l = config.base_resolution * (config.scale**level) - 1.0
            pos = x01c * scale_l + 0.5
        else:
            pos = x01c * r
        pf = torch.floor(pos).clamp(0, r - 1)
        frac = pos - pf
        w = torch.where(hi[None], frac[:, None, :], 1.0 - frac[:, None, :]).prod(dim=-1)
        if config.layout == "cell":
            idx = _cell_indices(config, level, pf.long())
            feats = lvl_table.index_select(0, idx).reshape(n, num_corners,
                                                           config.level_dim)
        else:
            corners = pf.long()[:, None, :] + bits.long()[None]
            idx = _corner_indices(config, level, corners)
            feats = lvl_table.index_select(0, idx.reshape(-1)).reshape(
                n, num_corners, config.level_dim)
        outs.append((feats.float() * w[..., None]).sum(dim=1))
    out = torch.cat(outs, dim=-1)
    return out * in_bounds[:, None].to(out.dtype)
