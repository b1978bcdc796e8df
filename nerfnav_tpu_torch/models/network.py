"""NeRF field networks: hash grid + SH encoders and the sigma / color MLPs.

Counterpart of nerfnav_tpu/models/network.py. Params are a plain dict in the
reference's layout: "encoder" is a list of per-level tables, "sigma_net" and
"color_net" are lists of bias-free (in, out) weight matrices.

mlp_backend "xla" is the plain torch matmul chain with the reference's
per-layer casts; "fused" is the fused-MLP kernel (ops/fused_mlp.py).
"""

from dataclasses import dataclass
from functools import cached_property
import math

import torch

from nerfnav_tpu_torch.device import resolve_device, unported
from nerfnav_tpu_torch.ops import fused_mlp as _fused
from nerfnav_tpu_torch.ops.activation import trunc_exp
from nerfnav_tpu_torch.ops.hashgrid import HashGridConfig, hash_grid_encode, hash_grid_init
from nerfnav_tpu_torch.ops.spherical_harmonics import sh_encode, sh_output_dim


@dataclass(frozen=True)
class NetworkConfig:
    bound: float = 1.0
    encoding: str = "hashgrid"   # "hashgrid" | "tiledgrid" | "frequency"
    freq_degree: int = 10
    encoding_dir: str = "sphere_harmonics"  # | "frequency"
    sh_degree: int = 4
    freq_degree_dir: int = 4
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    bg_radius: float = -1.0
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    density_scale: float = 1.0
    mlp_dtype: str = "float32"
    mlp_backend: str = "xla"     # "xla" | "fused"
    grid_levels: int = 16
    grid_level_dim: int = 2
    grid_base_resolution: int = 16
    grid_log2_hashmap_size: int = 19
    grid_max_resolution: int = 2048
    grid_layout: str = "corner"
    grid_backward: str = "xla"
    grid_coord_convention: str = "vertex"
    grid_table_dtype: str = "float32"

    @cached_property
    def grid(self) -> HashGridConfig:
        return HashGridConfig(
            input_dim=3,
            num_levels=self.grid_levels,
            level_dim=self.grid_level_dim,
            base_resolution=self.grid_base_resolution,
            log2_hashmap_size=self.grid_log2_hashmap_size,
            desired_resolution=int(self.grid_max_resolution * self.bound),
            gridtype="tiled" if self.encoding == "tiledgrid" else "hash",
            layout=self.grid_layout,
            backward=self.grid_backward,
            coord_convention=self.grid_coord_convention,
            table_compute_dtype=self.grid_table_dtype,
        )

    @cached_property
    def pos_dim(self) -> int:
        if self.encoding in ("hashgrid", "tiledgrid"):
            return self.grid.output_dim
        raise unported("frequency position encoding", "A1")

    @cached_property
    def dir_dim(self) -> int:
        if self.encoding_dir == "sphere_harmonics":
            return sh_output_dim(self.sh_degree)
        raise unported("frequency direction encoding", "A1")

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.mlp_dtype == "bfloat16" else torch.float32


def _check_supported(cfg: NetworkConfig):
    if cfg.bg_radius > 0:
        raise unported("the background network (bg_radius > 0)", "A3")
    if cfg.mlp_backend not in ("xla", "fused"):
        raise ValueError(f"unknown mlp_backend {cfg.mlp_backend!r}")
    _ = (cfg.pos_dim, cfg.dir_dim)  # raises for the unported encoders


def _mlp_init(generator, dims, device):
    """torch.nn.Linear default: U(-1/sqrt(d_in), 1/sqrt(d_in)), (in, out)."""
    out = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        lim = 1.0 / math.sqrt(d_in)
        w = torch.rand((d_in, d_out), generator=generator) * (2 * lim) - lim
        out.append(w.to(device))
    return out


def init_network(generator, cfg: NetworkConfig, device="cuda"):
    """The params dict, drawn from a CPU torch.Generator (or None)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    params = {"encoder": hash_grid_init(generator, cfg.grid, device=dev)}
    sigma_dims = ([cfg.pos_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
                  + [1 + cfg.geo_feat_dim])
    params["sigma_net"] = _mlp_init(generator, sigma_dims, dev)
    color_dims = ([cfg.dir_dim + cfg.geo_feat_dim]
                  + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1) + [3])
    params["color_net"] = _mlp_init(generator, color_dims, dev)
    return params


def _mlp_apply(layers, x, dtype, final_activation=None, backend="xla"):
    """Bias-free MLP with ReLU hidden activations."""
    if backend == "fused":
        h = _fused.fused_mlp(x.float(), list(layers), "relu", "none")
        if final_activation is not None:
            h = final_activation(h)
        return h
    h = x.to(dtype)
    for i, w in enumerate(layers):
        h = h @ w.to(dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    h = h.float()
    if final_activation is not None:
        h = final_activation(h)
    return h


def _encode_pos(params, x, cfg: NetworkConfig):
    if cfg.encoding in ("hashgrid", "tiledgrid"):
        return hash_grid_encode(params["encoder"], x, cfg.grid, bound=cfg.bound)
    raise unported("frequency position encoding", "A1")


def _encode_dir(d, cfg: NetworkConfig):
    if cfg.encoding_dir == "sphere_harmonics":
        return sh_encode(d, degree=cfg.sh_degree)
    raise unported("frequency direction encoding", "A1")


def density(params, x, cfg: NetworkConfig):
    """x: (N, 3) in [-bound, bound] -> {"sigma": (N,), "geo_feat": (N, geo)}."""
    h = _encode_pos(params, x, cfg)
    h = _mlp_apply(params["sigma_net"], h, cfg.compute_dtype, backend=cfg.mlp_backend)
    return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}


def color(params, d, geo_feat, cfg: NetworkConfig):
    """d: (N, 3) unit view directions; geo_feat: (N, geo). Returns rgb (N, 3)."""
    return color_from_encoded_dir(params, _encode_dir(d, cfg), geo_feat, cfg)


def color_from_encoded_dir(params, hd, geo_feat, cfg: NetworkConfig):
    """Color head on pre-encoded directions (a ray's direction is encoded once
    and broadcast over its samples)."""
    h = torch.cat([hd, geo_feat], dim=-1)
    return _mlp_apply(params["color_net"], h, cfg.compute_dtype, torch.sigmoid,
                      backend=cfg.mlp_backend)


def forward(params, x, d, cfg: NetworkConfig):
    out = density(params, x, cfg)
    return out["sigma"], color(params, d, out["geo_feat"], cfg)
