"""NeRF field networks: the position and direction encoders, the sigma /
color MLPs and the optional background network.

Counterpart of nerfnav_tpu/models/network.py. Params are a plain dict in the
reference's layout: "encoder" is a list of per-level tables (absent for a
frequency-encoded field), "sigma_net" and "color_net" are lists of bias-free
(in, out) weight matrices; with bg_radius > 0, "bg_encoder" holds the 2-D
hash grid over where a ray leaves the background sphere and "bg_net" the MLP
that gives the ray's background colour.

`MipNerfConfig` is the other kind of field, mip-NeRF's (Barron et al.
2021, arXiv 2103.13415): no grid, an integrated positional encoding of cone
frustums (ops/ipe.py) into one 8 x 256 ReLU MLP with biases and a skip,
shared by a coarse and a fine level (models/renderer.py `render_rays_mip`).
Its params are lists of [weight (in, out), bias] pairs: "trunk" (the 8
layers), "sigma", "bottleneck", "view" and "rgb".

mlp_backend "xla" is the plain torch matmul chain with the reference's
per-layer casts; "fused" is the fused-MLP kernel (ops/fused_mlp.py).
grid_backend "fused" (the default) is the hash-grid kernel (ops/hashgrid.py,
csrc/hashgrid.cu) on a CUDA tensor, for the field's grid and the
background's; "xla" is the plain eager encode, which nav's configs take
(make_configs(for_nav=True)): nav differentiates the encode in forward mode.

Each config holds its field's recipe (`init_params`, `adam_*`, `train_lr`,
`keeps_ema`, `dense_draws`, `cone_rays`, `loss`, `bounded`, `grid_meta`,
`train_background`): the Trainer, checkpoints and CLI read it, not the type.
"""

from dataclasses import dataclass
from functools import cached_property
import math
from typing import ClassVar

import torch

from nerfnav_tpu_torch.device import device_const, resolve_device
from nerfnav_tpu_torch.ops import fused_mlp as _fused
from nerfnav_tpu_torch.ops import mip_gemm as mg
from nerfnav_tpu_torch.ops.activation import trunc_exp
from nerfnav_tpu_torch.ops.frequency import freq_encode, freq_output_dim
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
    grid_backend: str = "fused"    # "fused" | "xla"
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
            backend=self.grid_backend,
        )

    @cached_property
    def bg_grid(self) -> HashGridConfig:
        """The background's 2-D hash grid over sphere coordinates."""
        return HashGridConfig(
            input_dim=2,
            num_levels=4,
            level_dim=2,
            base_resolution=16,
            log2_hashmap_size=19,
            desired_resolution=2048,
            coord_convention=self.grid_coord_convention,
            backend=self.grid_backend,
        )

    @cached_property
    def pos_dim(self) -> int:
        if self.encoding in ("hashgrid", "tiledgrid"):
            return self.grid.output_dim
        return freq_output_dim(3, self.freq_degree)

    @cached_property
    def dir_dim(self) -> int:
        if self.encoding_dir == "sphere_harmonics":
            return sh_output_dim(self.sh_degree)
        return freq_output_dim(3, self.freq_degree_dir)

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.mlp_dtype == "bfloat16" else torch.float32

    # torch-ngp's recipe: Adam(0.9, 0.99, eps 1e-15), an EMA, rays in the bound cube
    adam_betas: ClassVar[tuple] = (0.9, 0.99)
    adam_eps: ClassVar[float] = 1e-15
    keeps_ema: ClassVar[bool] = True
    cone_rays: ClassVar[bool] = False
    bounded: ClassVar[bool] = True
    train_background: ClassVar[str] = "random"

    def init_params(self, generator, device):
        """init_network: torch-ngp's tables and torch.nn.Linear's weights."""
        return init_network(generator, self, device=device)

    def train_lr(self, count: int, opt) -> float:
        """torch-ngp's LambdaLR at Adam's pre-increment count (as optax's)."""
        return opt.lr * (0.1 ** (count / (opt.lr_iters or max(1, opt.iters))))

    def dense_draws(self, gen, n: int, rcfg, device) -> dict:
        """render_rays' jitter and importance draws (None without) for n rays."""
        return {"jitter": torch.rand((n, rcfg.num_steps), generator=gen, device=device),
                "u": (torch.rand((n, rcfg.upsample_steps), generator=gen, device=device)
                      if rcfg.upsample_steps > 0 else None)}

    def loss(self, out, gt):
        """(loss, per-ray MSE) of a render against its pixels: torch-ngp's mean."""
        per_ray = ((out["image"] - gt) ** 2).mean(dim=-1)
        return per_ray.mean(), per_ray

    def grid_meta(self) -> dict:
        """The grid-architecture fingerprint a checkpoint records."""
        return {k: getattr(self, "grid_" + k) for k in (
            "levels", "level_dim", "log2_hashmap_size", "layout", "coord_convention",
            "max_resolution")}


def _mlp_init(generator, dims, device):
    """torch.nn.Linear default: U(-1/sqrt(d_in), 1/sqrt(d_in)), (in, out)."""
    out = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        lim = 1.0 / math.sqrt(d_in)
        w = torch.rand((d_in, d_out), generator=generator) * (2 * lim) - lim
        out.append(w.to(device))
    return out


def init_network(generator, cfg: NetworkConfig, device="cuda"):
    """The params dict, drawn from a CPU torch.Generator (or None) in the
    order encoder, sigma_net, color_net, bg_encoder, bg_net."""
    if cfg.mlp_backend not in ("xla", "fused"):
        raise ValueError(f"unknown mlp_backend {cfg.mlp_backend!r}")
    if cfg.grid_backend not in ("xla", "fused"):
        raise ValueError(f"unknown grid_backend {cfg.grid_backend!r}")
    dev = resolve_device(device)
    params = {}
    if cfg.encoding in ("hashgrid", "tiledgrid"):
        params["encoder"] = hash_grid_init(generator, cfg.grid, device=dev)
    sigma_dims = ([cfg.pos_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
                  + [1 + cfg.geo_feat_dim])
    params["sigma_net"] = _mlp_init(generator, sigma_dims, dev)
    color_dims = ([cfg.dir_dim + cfg.geo_feat_dim]
                  + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1) + [3])
    params["color_net"] = _mlp_init(generator, color_dims, dev)
    if cfg.bg_radius > 0:
        params["bg_encoder"] = hash_grid_init(generator, cfg.bg_grid, device=dev)
        bg_dims = ([cfg.bg_grid.output_dim + cfg.dir_dim]
                   + [cfg.hidden_dim_bg] * (cfg.num_layers_bg - 1) + [3])
        params["bg_net"] = _mlp_init(generator, bg_dims, dev)
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
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which can end a bit off the CPU's quotient
    return freq_encode(x / device_const(cfg.bound, x.device), degree=cfg.freq_degree)


def _encode_dir(d, cfg: NetworkConfig):
    if cfg.encoding_dir == "sphere_harmonics":
        return sh_encode(d, degree=cfg.sh_degree)
    return freq_encode(d, degree=cfg.freq_degree_dir)


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


def background(params, sph, d, cfg: NetworkConfig):
    """Background colour (N, 3) from sphere coordinates sph (N, 2) in
    [-1, 1] (renderer.sph_from_ray) and the rays' directions d (N, 3)."""
    h_sph = hash_grid_encode(params["bg_encoder"], sph, cfg.bg_grid, bound=1.0)
    h = torch.cat([h_sph, _encode_dir(d, cfg)], dim=-1)
    return _mlp_apply(params["bg_net"], h, cfg.compute_dtype, torch.sigmoid,
                      backend=cfg.mlp_backend)


@dataclass(frozen=True)
class MipNerfConfig:
    """mip-NeRF at google/mipnerf's defaults (`MipNerfModel`, `MLP` and the
    Blender `Config`): the field, its two sampling levels and its training
    recipe. The MLP is the torch matmul chain (bf16 operands, float32
    products, sums, biases and activations)."""
    min_deg_point: int = 0
    max_deg_point: int = 16
    deg_view: int = 4
    net_depth: int = 8
    net_width: int = 256
    net_depth_condition: int = 1
    net_width_condition: int = 128
    skip_layer: int = 4
    density_bias: float = -1.0
    rgb_padding: float = 0.001
    num_samples: int = 128
    num_levels: int = 2
    resample_padding: float = 0.01
    near: float = 2.0
    far: float = 6.0
    coarse_loss_mult: float = 0.1
    lr_init: float = 5e-4
    lr_final: float = 5e-6
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 0.01
    max_steps: int = 1_000_000
    adam_betas: tuple = (0.9, 0.999)
    adam_eps: float = 1e-8
    # not a field, and never the fused MLP (ops/mip_gemm.py runs this one):
    # kept for perfbench/drivers/train_mip.py::check_program_config to read
    mlp_backend: ClassVar[str] = "xla"
    keeps_ema: ClassVar[bool] = False
    cone_rays: ClassVar[bool] = True
    bounded: ClassVar[bool] = False
    train_background: ClassVar[str] = "white"

    @property
    def pos_dim(self) -> int:
        return 6 * (self.max_deg_point - self.min_deg_point)

    @property
    def dir_dim(self) -> int:
        return 3 + 6 * self.deg_view

    def layer_dims(self) -> dict:
        """(in, out) of every layer, by params key, in params order."""
        w, dims, d_in = self.net_width, [], self.pos_dim
        for i in range(self.net_depth):
            dims.append((d_in, w))
            d_in = w + self.pos_dim if i % self.skip_layer == 0 and i > 0 else w
        if self.net_depth_condition != 1:
            raise ValueError("the view branch is one layer in this port")
        return {"trunk": dims, "sigma": [(d_in, 1)], "bottleneck": [(d_in, w)],
                "view": [(w + self.dir_dim, self.net_width_condition)],
                "rgb": [(self.net_width_condition, 3)]}

    def lr(self, step: int) -> float:
        """The learning rate at 1-based step `step`: log-linear from
        lr_init to lr_final over max_steps, times a sine warm-up from
        lr_delay_mult over lr_delay_steps (mipnerf `learning_rate_decay`)."""
        delay = self.lr_delay_mult + (1.0 - self.lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / self.lr_delay_steps, 0.0), 1.0))
        t = min(max(step / self.max_steps, 0.0), 1.0)
        return delay * math.exp(math.log(self.lr_init) * (1.0 - t) + math.log(self.lr_final) * t)

    def init_params(self, generator, device):
        """init_mipnerf: mipnerf's Glorot-uniform weights and zero biases."""
        return init_mipnerf(generator, self, device=device)

    def train_lr(self, count: int, opt) -> float:
        """`lr` at Adam's pre-increment count + 1 (mipnerf's first step is 1)."""
        return self.lr(count + 1)

    def dense_draws(self, gen, n: int, rcfg, device) -> dict:
        """render_rays_mip's strata jitter, then resampling u, each (n, num_samples + 1)."""
        s = self.num_samples + 1
        return {"jitter": torch.rand((n, s), generator=gen, device=device),
                "u": torch.rand((n, s), generator=gen, device=device)}

    def loss(self, out, gt):
        """(loss, the last level's per-ray MSE): mipnerf's coarse_loss_mult x
        the earlier levels' mean MSEs, plus the last level's."""
        per_ray = ((out["image"] - gt) ** 2).mean(dim=-1)
        loss = self.coarse_loss_mult * sum(
            ((img - gt) ** 2).mean() for img in out["level_images"][:-1])
        return loss + per_ray.mean(), per_ray

    def grid_meta(self) -> dict:
        """No grid, no fingerprint."""
        return {}


def init_mipnerf(generator, cfg: MipNerfConfig, device="cuda"):
    """mip-NeRF's params: Glorot-uniform weights U(-sqrt(6 / (in + out)),
    ...) drawn from a CPU torch.Generator (or None) in params order, zero
    biases."""
    dev = resolve_device(device)
    out = {}
    for key, dims in cfg.layer_dims().items():
        out[key] = []
        for d_in, d_out in dims:
            lim = math.sqrt(6.0 / (d_in + d_out))
            w = torch.rand((d_in, d_out), generator=generator) * (2 * lim) - lim
            out[key] += [w.to(dev), torch.zeros(d_out, device=dev)]
    return out


class _MipMLP(torch.autograd.Function):
    """mip-NeRF's MLP on M = N x T samples, with the backward written out so
    that only the bf16 operands are kept and every gradient is a float32
    product of bf16 operands, as in the forward. The wide layers (the trunk,
    the bottleneck, the view layer) run through ops/mip_gemm.py: on the card
    one kernel a layer each way, whose epilogue adds the bias, applies the
    relu and stores bf16 (forward), or adds the density head's rank-1 term,
    masks, stores bf16 and sums the bias gradient (input gradient); the
    one- and three-wide heads and the weight gradients are torch products.
    Inputs: the IPE features (M, pos_dim) and the per-ray view encoding (N,
    dir_dim), neither differentiated; then the weights and biases in params
    order. Returns (raw rgb (M, 3), raw density (M, 1)), float32."""

    @staticmethod
    def forward(ctx, x, cond, skip, *params):
        bf = torch.bfloat16
        ws = [w.to(bf) for w in params[0::2]]
        bs = params[1::2]
        depth = len(ws) - 4
        n, m = cond.shape[0], x.shape[0]
        width, dev = ws[0].shape[1], x.device
        # a skip layer's input [h, x0] is one buffer: the layer before writes
        # h into its first columns, and x0 is cast into the rest once
        bufs = {i: torch.empty((m, width + x.shape[1]), dtype=bf, device=dev)
                for i in range(1, depth) if i % skip == 0}
        tails = [buf[:, width:] for buf in bufs.values()]
        x0 = tails[0].copy_(x) if tails else x.to(bf)
        for tail in tails[1:]:
            tail.copy_(x0)
        h = x0
        ins = []
        for i in range(depth):
            ins.append(h)
            buf = bufs.get(i)
            h = mg.gemm_bias_act(h, ws[i], bs[i], relu=True,
                                 out=None if buf is None else buf[:, :width])
            if buf is not None:
                h = buf
        w_s, w_bn, w_v, w_r = ws[depth:]
        b_s, b_bn, b_v, b_r = bs[depth:]
        raw_density = mg.mm32(h, w_s, b_s)
        # the view layer's input [bottleneck, view encoding] padded to a
        # multiple of 8 columns with zeros, which meet the weight's missing
        # rows (read as zeros): the same sums, aligned rows; the bottleneck
        # writes its first columns
        pad = -(w_v.shape[0]) % 8
        v_in = torch.empty((m, w_v.shape[0] + pad), dtype=bf, device=dev)
        tail = torch.nn.functional.pad(cond, (0, pad))
        v_in.view(n, m // n, -1)[:, :, width:].copy_(tail[:, None, :])
        mg.gemm_bias_act(h, w_bn, b_bn, relu=False, out=v_in[:, :width])
        v = mg.gemm_bias_act(v_in, w_v, b_v, relu=True)
        raw_rgb = mg.mm32(v, w_r, b_r)
        ctx.view_rows = w_v.shape[0]
        ctx.save_for_backward(*ins, h, v_in, v, *ws[:depth], w_s, w_bn, w_v, w_r)
        return raw_rgb, raw_density

    @staticmethod
    def backward(ctx, g_rgb, g_density):
        bf = torch.bfloat16
        saved = ctx.saved_tensors
        depth = (len(saved) - 7) // 2
        ins, (h, v_in, v) = saved[:depth], saved[depth:depth + 3]
        ws = saved[depth + 3:2 * depth + 3]
        w_s, w_bn, w_v, w_r = saved[2 * depth + 3:]
        width = ws[0].shape[1]

        def layer(inp, g):
            """(bf16 g, weight gradient, bias gradient) of a layer from its
            bf16 input and the float32 gradient g of its output."""
            g16 = g.to(bf)
            return g16, mg.mm32(inp.t(), g16), g.sum(dim=0)

        gr, dw_r, db_r = layer(v, g_rgb)
        gv, dw_v, db_v = layer(v_in, mg.mm32(gr, w_r.t()).masked_fill_(v <= 0, 0.0))
        # the bottleneck is linear: no mask
        gbn, db_bn = mg.gemm_dgrad_mask(gv, w_v[:width])
        dw_bn = mg.mm32(h.t(), gbn)
        gd, dw_s, db_s = layer(h, g_density)
        # the density head has one output: its input gradient is one
        # product per entry, added in the top trunk layer's epilogue
        g16, db = mg.gemm_dgrad_mask(gbn, w_bn[:width], saved=h[:, :width],
                                     rank1=(gd, w_s[:width]))
        trunk = []
        for i in reversed(range(depth)):
            trunk = [mg.mm32(ins[i].t(), g16), db] + trunk
            if i > 0:
                # a skip layer's input gradient is wanted for h's columns only
                g16, db = mg.gemm_dgrad_mask(g16, ws[i][:width], saved=ins[i][:, :width])
        return (None, None, None, *trunk, dw_s, db_s, dw_bn, db_bn,
                dw_v[:ctx.view_rows], db_v, dw_r, db_r)


def mipnerf_mlp(params, x, dir_enc, cfg: MipNerfConfig):
    """(raw rgb (N, T, 3), raw density (N, T)) of mip-NeRF's MLP at the IPE
    features x (N, T, pos_dim) of N rays' samples and the rays' view
    encodings dir_enc (N, dir_dim)."""
    n, t = x.shape[:2]
    flat = [p for k in ("trunk", "sigma", "bottleneck", "view", "rgb") for p in params[k]]
    raw_rgb, raw_density = _MipMLP.apply(x.reshape(n * t, -1), dir_enc, cfg.skip_layer, *flat)
    return raw_rgb.reshape(n, t, 3), raw_density.reshape(n, t)


def param_groups(params):
    """A label per params key: "encoder" for the tables (keys that contain
    "encoder"), "net" for the MLPs."""
    return {k: "encoder" if "encoder" in k else "net" for k in params}
