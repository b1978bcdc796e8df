"""Volume rendering over the occupancy grid.

Counterpart of nerfnav_tpu/models/renderer.py (`Field`, `make_field`,
`near_far_from_aabb`, `composite`, `render_rays_grid` with its dense and
point-budget packed shades, `render_rays_grid_rounds`). The reference wraps
every round of the eval renderer in a `lax.cond`; eagerly those are Python
branches on the alive count, one host read per round. The dense
differentiable path (`render_rays`) is ROADMAP A4.
"""

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from nerfnav_tpu_torch.device import unported
from nerfnav_tpu_torch.models import network as net


class Field(NamedTuple):
    """Closure bundle the renderer consumes.

    density_fn: (N,3) -> (sigma (N,), geo_feat (N,G))
    color_fn:   (dirs (N,3), geo_feat (N,G)) -> rgb (N,3)
    encode_dir_fn / color_enc_fn: the split color path (direction encoded
    once per ray)."""

    density_fn: Callable
    color_fn: Callable
    bound: float
    density_scale: float = 1.0
    bg_fn: Optional[Callable] = None
    bg_radius: float = -1.0
    encode_dir_fn: Optional[Callable] = None
    color_enc_fn: Optional[Callable] = None


def make_field(params, cfg: "net.NetworkConfig") -> Field:
    """Bundle a network's params into renderer closures."""
    if cfg.bg_radius > 0:
        raise unported("the background network (bg_radius > 0)", "A3")

    def density_fn(x):
        out = net.density(params, x, cfg)
        return out["sigma"], out["geo_feat"]

    def color_fn(d, geo_feat):
        return net.color(params, d, geo_feat, cfg)

    def encode_dir_fn(d):
        return net._encode_dir(d, cfg)

    def color_enc_fn(hd, geo_feat):
        return net.color_from_encoded_dir(params, hd, geo_feat, cfg)

    return Field(density_fn=density_fn, color_fn=color_fn, bound=cfg.bound,
                 density_scale=cfg.density_scale, encode_dir_fn=encode_dir_fn,
                 color_enc_fn=color_enc_fn)


@dataclass(frozen=True)
class RenderConfig:
    num_steps: int = 128
    upsample_steps: int = 128
    min_near: float = 0.2
    max_ray_batch: int = 4096


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float = 0.2):
    """Slab-test ray/AABB intersection; aabb (6,) tensor. Rays that miss get
    near == far."""
    d = torch.where(rays_d.abs() < 1e-9, torch.full_like(rays_d, 1e-9), rays_d)
    inv_d = 1.0 / d
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    near = torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=min_near)
    far = torch.maximum(torch.maximum(t0, t1).amin(dim=-1), near)
    return near, far


def _excl_trans(alphas):
    """Transmittance before each sample: shifted cumprod of (1 - alpha)."""
    t = torch.cumprod(1.0 - alphas + 1e-15, dim=-1)
    return torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], dim=-1)


def composite(sigmas, rgbs, deltas, z_vals, density_scale: float = 1.0):
    """Alpha compositing along the last sample axis. sigmas (N,T), rgbs
    (N,T,3), deltas/z_vals (N,T) -> (image, depth, weights_sum, weights)."""
    alphas = 1.0 - torch.exp(-deltas * density_scale * sigmas)
    weights = alphas * _excl_trans(alphas)
    return (
        (weights[..., None] * rgbs).sum(dim=-2),
        (weights * z_vals).sum(dim=-1),
        weights.sum(dim=-1),
        weights,
    )


def _unit(v):
    return v / torch.sqrt((v * v).sum(dim=-1, keepdim=True))


def _clip(x, lo: float, hi: float):
    """jnp.clip with its gradient: maximum/minimum pass half of it at a tie,
    where torch.clamp passes all."""
    lo_t = torch.full((), lo, device=x.device, dtype=x.dtype)
    return torch.minimum(torch.maximum(x, lo_t), lo_t + (hi - lo))


def render_rays_grid(field: Field, occupancy, mcfg, rays_o, rays_d, key=None,
                     bg_color=1.0, sample_budget=None, crop_aabb=None,
                     sample_groups: int = 1):
    """Occupancy-grid rendering in one shot, the training render.

    March (without gradient, like the reference's stop_gradient), shade the
    (N, K) samples densely or, with `sample_budget` < N*K, only the first
    `sample_budget` valid samples packed ray by ray (the rest are dropped
    tail first), composite, add the background. key: a MarchKey or None;
    bg_color: scalar, (3,) or (N, 3). Returns {"image", "depth",
    "weights_sum", "n_samples"}; n_samples is the valid count before the
    budget, a 0-d tensor."""
    from nerfnav_tpu_torch.ops.marching import march

    if sample_groups != 1:
        raise unported("sample_groups > 1 (per-shard packing under a mesh)", "A11")
    if field.bg_fn is not None and field.bg_radius > 0:
        raise unported("background network compositing", "A3")
    n = rays_o.shape[0]
    with torch.no_grad():
        m = march(rays_o, rays_d, occupancy, mcfg, key=key, crop_aabb=crop_aabb)
    z, dt, valid = m["z"], m["dt"], m["valid"]
    k = z.shape[1]
    n_samples = valid.sum()
    if sample_budget is not None and sample_budget < n * k:
        sigmas, rgbs = _shade_packed(field, rays_o, rays_d, z, valid,
                                     sample_budget, mcfg.bound)
    else:
        sigmas, rgbs = _shade_dense(field, rays_o, rays_d, z, valid, mcfg.bound)
    image, depth, weights_sum, _ = composite(sigmas, rgbs, dt, z, field.density_scale)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=rays_o.device)
    image = _clip(image + (1.0 - weights_sum)[:, None] * bg, 0.0, 1.0)
    return {"image": image, "depth": depth, "weights_sum": weights_sum,
            "n_samples": n_samples}


def _shade_dense(field: Field, rays_o, rays_d, z, valid, bound: float):
    """Field over the full (N, K) lattice: density at o + d z (invalid slots
    zeroed), color from each ray's direction encoded once."""
    n, k = z.shape
    pos = torch.clamp(rays_o[:, None, :] + rays_d[:, None, :] * z[..., None], -bound, bound)
    sigmas, geo = field.density_fn(pos.reshape(-1, 3))
    sigmas = torch.where(valid.reshape(-1), sigmas, 0.0).reshape(n, k)
    hd = field.encode_dir_fn(_unit(rays_d))
    e = hd.shape[-1]
    rgbs = field.color_enc_fn(hd[:, None, :].expand(n, k, e).reshape(-1, e), geo)
    return sigmas, rgbs.reshape(n, k, 3)


def _pack_indices(valid, budget: int):
    """Packed slot -> (ray r, in-ray position j, slot in use) for a per-ray
    prefix mask (N, K): (budget,) int64, int64, bool. Each ray's id and its
    segment start are written at the start, and a running max (cummax)
    fills each segment; a ray with no samples shares its start with the
    next ray, which the max resolves to the later one."""
    n, _ = valid.shape
    counts = valid.sum(dim=1)
    offsets = torch.cumsum(counts, 0) - counts
    total = offsets[-1] + counts[-1]
    at = torch.clamp(offsets, max=budget)  # starts past the budget drop
    seg_ray = torch.zeros(budget + 1, dtype=torch.int64, device=valid.device)
    seg_ray.scatter_reduce_(0, at, torch.arange(n, device=valid.device), "amax")
    seg_off = torch.zeros(budget + 1, dtype=torch.int64, device=valid.device)
    seg_off.scatter_reduce_(0, at, offsets, "amax")
    r = torch.cummax(seg_ray[:budget], 0).values
    p = torch.arange(budget, device=valid.device)
    return r, p - torch.cummax(seg_off[:budget], 0).values, p < total


def _shade_packed(field: Field, rays_o, rays_d, z, valid, budget: int, bound: float):
    """Field over a packed buffer of the first `budget` valid samples (valid
    is a per-ray prefix), scattered back into the dense (N, K) layout for the
    unchanged composite. A packed sample whose dense slot is invalid shades
    nothing (the reference's defence against a mask that is no prefix)."""
    n, k = z.shape
    r, j, pvalid = _pack_indices(valid, budget)
    flat = torch.clamp(r * k + j, 0, n * k - 1)
    zp = z.reshape(-1)[flat]
    pvalid_slot = valid.reshape(-1)[flat]
    hd = field.encode_dir_fn(_unit(rays_d))
    rb = torch.cat([rays_o, rays_d, hd], dim=-1)[r]
    pos = torch.clamp(rb[:, :3] + rb[:, 3:6] * zp[:, None], -bound, bound)
    sig_p, geo_p = field.density_fn(pos)
    sig_p = torch.where(pvalid & pvalid_slot, sig_p, 0.0)
    rgb_p = field.color_enc_fn(rb[:, 6:], geo_p)
    vals = torch.cat([sig_p[:, None], rgb_p], dim=-1)
    tgt = torch.where(pvalid, flat, n * k)  # unused slots land in a spare row
    buf = torch.zeros((n * k + 1, 4), device=z.device).index_put((tgt,), vals)[: n * k]
    return buf[:, 0].reshape(n, k), buf[:, 1:].reshape(n, k, 3)


def render_rays_grid_rounds(field: Field, occupancy, mcfg, rays_o, rays_d,
                            key=None, bg_color=1.0, round_samples: int = 8,
                            crop_aabb=None, round_compact: int = 4,
                            shade_order: str = "ray", z_window=None,
                            phase_a=None):
    """Grid-path rendering with early termination.

    March the static budget K once, then shade it in rounds of
    `round_samples`; a round is skipped when every ray is dead (T < 1e-4) or
    has no valid samples left in it. With round_compact > 1, a round with at
    most n / round_compact live rays shades only those (gathered to a fixed
    n / round_compact width) and scatters the result back."""
    from nerfnav_tpu_torch.ops.marching import march

    if shade_order not in ("ray", "depth"):
        raise ValueError(f"unknown shade_order {shade_order!r}")
    if field.bg_fn is not None and field.bg_radius > 0:
        raise unported("background network compositing", "A3")
    n = rays_o.shape[0]
    m = march(rays_o, rays_d, occupancy, mcfg, key=key, crop_aabb=crop_aabb,
              z_window=z_window, phase_a=phase_a)
    z, dt, valid = m["z"], m["dt"], m["valid"]
    k = z.shape[1]
    r = min(round_samples, k)
    dirs = _unit(rays_d)
    hd_ray = field.encode_dir_fn(dirs) if field.encode_dir_fn else None
    hd_or_dirs = hd_ray if hd_ray is not None else dirs

    def color(hd_b, geo):
        if hd_ray is not None:
            return field.color_enc_fn(hd_b, geo)
        return field.color_fn(hd_b, geo)

    def shade_core(o_c, d_c, hd_c, trans_c, zc, dtc, vc):
        """One round at the width of its inputs: per-ray contribution deltas
        and the updated transmittance."""
        w, rc = zc.shape
        e = hd_c.shape[-1]
        pos = o_c[:, None, :] + d_c[:, None, :] * zc[..., None]
        pos = torch.clamp(pos, -mcfg.bound, mcfg.bound)
        if shade_order == "depth":
            # depth-major order: consecutive points are adjacent rays at the
            # same depth
            sigmas, geo = field.density_fn(pos.transpose(0, 1).reshape(-1, 3))
            sigmas = torch.where(vc.T.reshape(-1), sigmas, 0.0).reshape(rc, w).T
            hd_b = hd_c[None, :, :].expand(rc, w, e).reshape(-1, e)
            rgbs = color(hd_b, geo).reshape(rc, w, 3).transpose(0, 1)
        else:
            sigmas, geo = field.density_fn(pos.reshape(-1, 3))
            sigmas = torch.where(vc.reshape(-1), sigmas, 0.0).reshape(w, rc)
            hd_b = hd_c[:, None, :].expand(w, rc, e).reshape(-1, e)
            rgbs = color(hd_b, geo).reshape(w, rc, 3)
        alphas = 1.0 - torch.exp(-dtc * field.density_scale * sigmas)
        t_within = _excl_trans(alphas)
        weights = alphas * trans_c[:, None] * t_within
        img_d = (weights[..., None] * rgbs).sum(dim=-2)
        dep_d = (weights * zc).sum(dim=-1)
        ws_d = weights.sum(dim=-1)
        trans_new = trans_c * t_within[:, -1] * (1.0 - alphas[:, -1] + 1e-15)
        return img_d, dep_d, ws_d, trans_new

    image = torch.zeros((n, 3), device=rays_o.device)
    depth = torch.zeros((n,), device=rays_o.device)
    wsum = torch.zeros((n,), device=rays_o.device)
    trans = torch.ones((n,), device=rays_o.device)
    n_comp = n // round_compact if round_compact and round_compact > 1 else 0
    for s in range(0, k, r):
        zc, dtc, vc = z[:, s : s + r], dt[:, s : s + r], valid[:, s : s + r]
        alive = (trans > 1e-4) & vc.any(dim=-1)
        na = int(alive.sum())  # host read: the eager form of the lax.cond
        if na == 0:
            continue
        if n_comp and na <= n_comp:
            # fixed-width compaction: the live rays first, in ray order
            # (stable sort of ~alive), padded with dead rays that shade
            # nothing and write nothing back
            order = torch.argsort((~alive).to(torch.uint8), stable=True)[:n_comp]
            keep = alive[order]
            img_d, dep_d, ws_d, trans_new = shade_core(
                rays_o[order], rays_d[order], hd_or_dirs[order], trans[order],
                zc[order], dtc[order], vc[order] & keep[:, None])
            idx = order[keep]
            image[idx] += img_d[keep]
            depth[idx] += dep_d[keep]
            wsum[idx] += ws_d[keep]
            trans[idx] = trans_new[keep]
        else:
            img_d, dep_d, ws_d, trans = shade_core(
                rays_o, rays_d, hd_or_dirs, trans, zc, dtc, vc)
            image = image + img_d
            depth = depth + dep_d
            wsum = wsum + ws_d

    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=rays_o.device)
    image = image + (1.0 - wsum)[:, None] * bg
    return {"image": image.clamp(0.0, 1.0), "depth": depth, "weights_sum": wsum}
