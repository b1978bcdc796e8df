"""Multiresolution hash-grid encoding (Instant-NGP), differentiable.

Counterpart of nerfnav_tpu/ops/hashgrid.py: the same level schedule, table
layouts ("corner": one F-wide row per lattice vertex, 8 gathers per point and
level; "cell": one 8F-wide row per cell, 1 gather), lattice conventions
("vertex", "ngp"), out-of-bounds zeroing and bf16 table compute.

`hash_grid_encode` runs the hand-written CUDA kernels of csrc/hashgrid.cu
for a CUDA tensor under `backend="fused"` (one launch forward, one for the
table gradient, one for dy/dx when x requires it; see `_HashGridKernel`),
and the plain version `hash_grid_encode_plain` otherwise: on the CPU, and
under `backend="xla"`, which nav takes because it differentiates the
encode in forward mode (`torch.func.jacfwd`) and the kernel has no jvp.

The plain version: index math runs in int64 and is cut to 32 bits after
every product, so the hashes match the reference's uint32 arithmetic bit for
bit: the primes exceed int32. The gather is plain torch `index_select`, so
autograd gives the table gradient as an `index_add_` of the weighted output
gradients (the reference's "xla" backward) and dy/dx through the trilinear
weights. The reference's "sort" backward sums the same rows in another order
(a sorted segment sum); the plain version computes it as "xla" does, the
kernel path by its deterministic route. With bf16 table compute the plain
gradient is accumulated in bf16 and cast back to f32 once per table, as in
the reference; the kernel path trains no bf16 table and raises.
"""

from dataclasses import dataclass
from functools import cached_property
import ctypes
import math

import numpy as np
import torch

from nerfnav_tpu_torch.device import device_const, resolve_device
from nerfnav_tpu_torch.utils.profiling import count

# Spatial hash primes (reference gridencoder.cu:36-51).
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF
_MAX_LEVELS = 32
# output floats per point of one level group of the kernels (grid y): the
# levels a group takes are this over F. 8 floats, one 32-byte sector per
# point, keeps a few levels' tables hot in L2 at a time: at the benchmark's
# grid (F = 2) and N = 2^21 on an H100 the forward took 2.10 / 1.70 / 1.54 /
# 1.73 / 4.53 ms with groups of 1 / 2 / 4 / 8 / 16 levels
_GROUP_FLOATS = 8


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
    backward: str = "xla"  # "xla" | "sort" (the kernel path: its deterministic route)
    coord_convention: str = "vertex"  # "vertex" | "ngp"
    table_compute_dtype: str = "float32"  # "float32" | "bfloat16"
    backend: str = "fused"  # "fused" (the CUDA kernels on a CUDA tensor) | "xla" (plain)

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

    @cached_property
    def kernel_levels(self) -> tuple:
        """The kernel's per-level arguments (csrc/hashgrid.cu), as ctypes
        arrays: the position scales in float32, as the plain version's
        multiply rounds them (R, or base s^l - 1 under the ngp convention),
        and 5 uint32 a level: R, the dense row stride (R + 1 a corner, R a
        cell), the row wrap (0 for none, else the rows are taken modulo it),
        hashed or dense, and the row count. Raises ValueError on a
        configuration the kernel does not take."""
        if self.input_dim not in (2, 3):
            raise ValueError(f"the hash-grid kernel takes input_dim 2 or 3, got {self.input_dim}")
        if self.level_dim not in (1, 2, 4, 8):
            raise ValueError(
                f"the hash-grid kernel takes level_dim 1, 2, 4 or 8, got {self.level_dim}")
        if not 1 <= self.num_levels <= _MAX_LEVELS:
            raise ValueError(
                f"the hash-grid kernel takes 1..{_MAX_LEVELS} levels, got {self.num_levels}")
        for name, value, allowed in (
                ("gridtype", self.gridtype, ("hash", "tiled")),
                ("layout", self.layout, ("corner", "cell")),
                ("coord_convention", self.coord_convention, ("vertex", "ngp")),
                ("backward", self.backward, ("xla", "sort")),
                ("table_compute_dtype", self.table_compute_dtype, ("float32", "bfloat16"))):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}: the kernel takes {allowed}")
        cell = self.layout == "cell"
        max_rows = 2**self.log2_hashmap_size
        scales, params = [], []
        for level, (r, size) in enumerate(zip(self.resolutions, self.level_sizes)):
            fits = (r if cell else r + 1) ** self.input_dim <= max_rows
            hashed = self.gridtype == "hash" and not fits
            wrap = 0 if fits else (max_rows if hashed and not cell else size)
            if self.coord_convention == "ngp":
                scales.append(self.base_resolution * (self.scale**level) - 1.0)
            else:
                scales.append(float(r))
            params += [r, r if cell else r + 1, wrap, int(hashed), size]
        return ((ctypes.c_float * len(scales))(*np.float32(scales).tolist()),
                (ctypes.c_uint32 * len(params))(*params))


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


def hash_grid_encode_plain(table, x: torch.Tensor, config: HashGridConfig,
                           bound: float = 1.0) -> torch.Tensor:
    """The plain version of `hash_grid_encode` in eager torch ops: the CPU
    path, nav's (`backend="xla"`), and the kernel's yardstick on the card."""
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


def _check_kernel_args(table, x: torch.Tensor, config: HashGridConfig):
    """Raises ValueError on what the kernel does not take."""
    config.kernel_levels  # raises on a configuration the kernel does not take
    if x.dim() != 2 or x.shape[1] != config.input_dim:
        raise ValueError(f"x must be (N, {config.input_dim}), got {tuple(x.shape)}")
    if x.shape[0] >= 2**31:
        raise ValueError(f"the hash-grid kernel takes N < 2^31, got {x.shape[0]}")
    if len(table) != config.num_levels:
        raise ValueError(f"{config.num_levels} level tables expected, got {len(table)}")
    dtype = table[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the hash-grid kernel takes float32 or bfloat16 tables, got {dtype}")
    for t, size in zip(table, config.level_sizes):
        if t.dtype != dtype or t.device != x.device or tuple(t.shape) != (size, config.row_dim):
            raise ValueError(
                f"each table must be ({size}, {config.row_dim}) {dtype} on {x.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if (torch.is_grad_enabled() and any(t.requires_grad for t in table)
            and (dtype == torch.bfloat16 or config.table_compute_dtype == "bfloat16")):
        raise ValueError("the hash-grid kernel does not train a table in bf16 compute: "
                         "train with table_compute_dtype float32, or use backend 'xla'")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned, as the kernel's vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _call(fn: str, *args):
    """Call kernel function `fn` of csrc/hashgrid.cu; adds one to
    `hash_grid_encode.launches`."""
    from nerfnav_tpu_torch import kernels

    err = getattr(kernels.load("hashgrid"), fn)(*args)
    if err != 0:
        raise RuntimeError(f"hash-grid kernel {fn} failed: CUDA error {err}")
    hash_grid_encode.launches += 1


def _group(config: HashGridConfig) -> int:
    """Levels per level group of the kernels (see _GROUP_FLOATS)."""
    return max(1, _GROUP_FLOATS // config.level_dim)


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


class _HashGridKernel(torch.autograd.Function):
    """The kernels of csrc/hashgrid.cu: the forward, the table gradient
    (atomic adds, or under torch's deterministic mode or backward="sort"
    the kernel's rows and values summed by torch's sorted index_put_) and,
    when x requires one, dy/dx."""

    @staticmethod
    def forward(ctx, x, config, bound, *table):
        xf = _aligned(x.float())
        tabs = [_aligned(t) for t in table]
        n = xf.shape[0]
        out = torch.empty((n, config.output_dim), device=x.device, dtype=torch.float32)
        ctx.config, ctx.bound, ctx.x_dtype = config, bound, x.dtype
        ctx.save_for_backward(xf, *(tabs if ctx.needs_input_grad[0] else ()))
        if n == 0:
            return out
        scales, params = config.kernel_levels
        ptrs = _pointers(tabs)
        bf16 = tabs[0].dtype == torch.bfloat16
        _call("nerfnav_hashgrid_forward", xf.data_ptr(), out.data_ptr(), n,
              config.input_dim, config.level_dim, config.layout == "cell", bf16,
              not bf16 and config.table_compute_dtype == "bfloat16",
              config.coord_convention == "ngp", bound, config.num_levels,
              _group(config), ctypes.addressof(ptrs),
              ctypes.addressof(scales), ctypes.addressof(params),
              torch.cuda.current_stream(x.device).cuda_stream)
        return out

    @staticmethod
    def backward(ctx, g):
        xf, *tabs = ctx.saved_tensors
        config, bound = ctx.config, ctx.bound
        g = _aligned(g.float())
        n = xf.shape[0]
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        scales, params = config.kernel_levels
        cell = config.layout == "cell"
        ngp = config.coord_convention == "ngp"
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.empty_like(xf)
            if n:
                bf16 = tabs[0].dtype == torch.bfloat16
                ptrs = _pointers(tabs)
                _call("nerfnav_hashgrid_dx", xf.data_ptr(), g.data_ptr(), dx.data_ptr(), n,
                      config.input_dim, config.level_dim, cell, bf16,
                      not bf16 and config.table_compute_dtype == "bfloat16", ngp, bound,
                      config.num_levels, ctypes.addressof(ptrs), ctypes.addressof(scales),
                      ctypes.addressof(params), stream)
            dx = dx.to(ctx.x_dtype)
        need = ctx.needs_input_grad[3:]
        grads = [None] * len(need)
        if any(need):
            # one buffer, one fill: level l's rows start at its 8-row-aligned
            # offset, so every view is 16-byte aligned
            flat = torch.zeros((config.total_params, config.row_dim), device=xf.device)
            grads = [flat[o:o + s] for o, s in zip(config.offsets, config.level_sizes)]
            rows = vals = None
            if torch.are_deterministic_algorithms_enabled() or config.backward == "sort":
                k = 1 if cell else 2**config.input_dim
                rows = torch.empty((config.num_levels, n * k), device=xf.device,
                                   dtype=torch.int64)
                vals = torch.empty((config.num_levels, n * k, config.row_dim),
                                   device=xf.device)
            if n:
                ptrs = _pointers(grads)
                _call("nerfnav_hashgrid_backward", xf.data_ptr(), g.data_ptr(), n,
                      config.input_dim, config.level_dim, cell, ngp, bound,
                      config.num_levels, _group(config),
                      ctypes.addressof(ptrs), ctypes.addressof(scales),
                      ctypes.addressof(params), None if rows is None else rows.data_ptr(),
                      None if vals is None else vals.data_ptr(), stream)
            if rows is not None:
                for gr, r, v in zip(grads, rows, vals):
                    gr.index_put_((r,), v, accumulate=True)
            grads = [gr if nd else None for gr, nd in zip(grads, need)]
        return (dx, None, None, *grads)


def hash_grid_encode(table, x: torch.Tensor, config: HashGridConfig,
                     bound: float = 1.0) -> torch.Tensor:
    """table: list of per-level (size_l, row_dim) tables; x: (N, D) in
    [-bound, bound]. Returns (N, num_levels * level_dim) float32;
    out-of-bounds points get all-zero features.

    config.backend "fused" launches the kernels of csrc/hashgrid.cu for a
    CUDA tensor (or raises: on a configuration, table or x they do not
    take, also for a CPU tensor) and runs the plain version for a CPU one;
    "xla" runs the plain version. Counts `grid_encode_kernel_calls` or
    `grid_encode_plain_calls` in the innermost span while tracing;
    `hash_grid_encode.launches` counts the kernel launches."""
    if config.backend == "fused":
        _check_kernel_args(table, x, config)
        if x.device.type == "cuda":
            count("grid_encode_kernel_calls", 1)
            return _HashGridKernel.apply(x, config, bound, *table)
    elif config.backend != "xla":
        raise ValueError(f"unknown hash-grid backend {config.backend!r}")
    count("grid_encode_plain_calls", 1)
    return hash_grid_encode_plain(table, x, config, bound)


hash_grid_encode.launches = 0
