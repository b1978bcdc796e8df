"""Volume rendering: the dense differentiable path and the occupancy grid.

Counterpart of nerfnav_tpu/models/renderer.py (`Field`, `make_field`,
`aabb_of`, `near_far_from_aabb`, `sph_from_ray`, `sample_pdf`, `composite`,
the dense `render_rays` and `render_image`, `render_rays_grid` with its
dense and point-budget packed shades, `render_rays_frozen`,
`render_rays_grid_rounds`). A field with a background network (bg_radius >
0) colours each ray's remaining transmittance from where the ray leaves the
background sphere, and every renderer then ignores bg_color.
The reference wraps every round of the eval renderer in a `lax.cond`;
eagerly those are Python branches on the alive count, one host read per
round.

The dense path and the frozen shade are what the nav stack differentiates,
in reverse mode (planner) and forward mode (the pose filter's
torch.func.jacfwd): they read no value back to the host and branch on no
data, so they run under vmap. Randomness is passed in as tensors (the
stratified jitter and the importance-sampling draws), not drawn inside.
"""

from dataclasses import dataclass
from functools import lru_cache
import math
from typing import Callable, NamedTuple, Optional

import torch

from nerfnav_tpu_torch.device import device_const
from nerfnav_tpu_torch.models import network as net
from nerfnav_tpu_torch.ops.marching import _excl_trans


class Field(NamedTuple):
    """Closure bundle the renderer consumes.

    density_fn: (N,3) -> (sigma (N,), geo_feat (N,G))
    color_fn:   (dirs (N,3), geo_feat (N,G)) -> rgb (N,3)
    encode_dir_fn / color_enc_fn: the split color path (direction encoded
    once per ray)
    bg_fn:      optional (sph (N,2), dirs (N,3)) -> rgb (N,3), used when
                bg_radius > 0"""

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

    def density_fn(x):
        out = net.density(params, x, cfg)
        return out["sigma"], out["geo_feat"]

    def color_fn(d, geo_feat):
        return net.color(params, d, geo_feat, cfg)

    def encode_dir_fn(d):
        return net._encode_dir(d, cfg)

    def color_enc_fn(hd, geo_feat):
        return net.color_from_encoded_dir(params, hd, geo_feat, cfg)

    bg_fn = None
    if cfg.bg_radius > 0:
        def bg_fn(sph, d):  # noqa: E306
            return net.background(params, sph, d, cfg)

    return Field(density_fn=density_fn, color_fn=color_fn, bound=cfg.bound,
                 density_scale=cfg.density_scale, bg_fn=bg_fn, bg_radius=cfg.bg_radius,
                 encode_dir_fn=encode_dir_fn, color_enc_fn=color_enc_fn)


@dataclass(frozen=True)
class RenderConfig:
    num_steps: int = 128
    upsample_steps: int = 128
    min_near: float = 0.2
    max_ray_batch: int = 4096


def aabb_of(bound: float, device="cpu"):
    """Train AABB [-b, -b, -b, b, b, b] as a shared (6,) float32 tensor."""
    return device_const([-bound] * 3 + [bound] * 3, device)


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


def sph_from_ray(rays_o, rays_d, radius: float):
    """Where each ray leaves the background sphere of `radius`, as (N, 2)
    coordinates in [-1, 1]: azimuth atan2(y, x) / pi and 2 acos(z / R) / pi
    - 1. Rays are assumed to start inside the sphere.

    Both quotients divide by device tensors (CUDA divides by a Python scalar
    as a multiply by its reciprocal, and the result feeds the 2-D grid's
    floor), and the clips are maximum / minimum, which split the gradient
    at a tie as jnp.maximum and jnp.clip do."""
    dev = rays_o.device
    b = (rays_o * rays_d).sum(dim=-1)
    c = (rays_o * rays_o).sum(dim=-1) - radius * radius
    d2 = (rays_d * rays_d).sum(dim=-1)
    disc = torch.maximum(b * b - d2 * c, device_const(0.0, dev))
    t = (-b + torch.sqrt(disc)) / torch.maximum(d2, device_const(1e-9, dev))
    p = rays_o + t[:, None] * rays_d
    u = torch.atan2(p[:, 1], p[:, 0]) / device_const(math.pi, dev)
    v = (2.0 * torch.acos(_clip(p[:, 2] / device_const(radius, dev), -1.0, 1.0))
         / device_const(math.pi, dev) - 1.0)
    return torch.stack([u, v], dim=-1)


@lru_cache(maxsize=None)
def _linspace_values(start: float, stop: float, num: int) -> tuple:
    if num == 1:
        return (start,)
    step = torch.arange(num - 1, dtype=torch.float32) / (num - 1)
    out = start * (1.0 - step) + stop * step
    return tuple(out.tolist()) + (stop,)


def linspace(start: float, stop: float, num: int, device="cpu"):
    """jnp.linspace's float32 values within a bit: start (1 - s) + stop s
    with s = i / (num - 1), the last entry exactly stop (torch.linspace
    counts the second half down from stop, which rounds differently).
    Computed once on the CPU and shared on `device` as a constant, so every
    device gets the same bits (CUDA divides by a scalar as a multiply by its
    reciprocal, which can end a bit off): a sample one bit away can sit
    across a hash-grid cell boundary, where the field's derivative jumps."""
    return device_const(_linspace_values(float(start), float(stop), num), device)


def sample_pdf(bins, weights, n_samples: int, u=None):
    """Inverse-CDF importance sampling. bins (N, T+1) edges, weights (N, T);
    u (N, n_samples) uniform draws, or None for the deterministic midpoints
    (i + 0.5) / n_samples. Returns (N, n_samples)."""
    n, t = weights.shape
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros((n, 1), dtype=pdf.dtype, device=pdf.device),
                     torch.cumsum(pdf, dim=-1)], dim=-1)
    if u is None:
        u = linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples, pdf.device)
        u = u.expand(n, n_samples)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, 0, t)
    above = torch.clamp(inds, 0, t)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)
    denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_a), cdf_a - cdf_b)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


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


def _background(field: Field, bg_color, rays_o, rays_d):
    """The colour behind each ray: the field's background network where it
    has one (bg_color is then ignored), else bg_color (a scalar, (3,) or
    (N, 3)). rays_d reaches the network un-normalized, as in the reference."""
    if field.bg_fn is not None and field.bg_radius > 0:
        return field.bg_fn(sph_from_ray(rays_o, rays_d, field.bg_radius), rays_d)
    if isinstance(bg_color, (int, float)):
        return device_const(bg_color, rays_o.device)
    return torch.as_tensor(bg_color, dtype=torch.float32, device=rays_o.device)


def render_rays(field: Field, rcfg: RenderConfig, rays_o, rays_d, jitter=None, u=None,
                bg_color=1.0, crop_aabb=None):
    """The dense differentiable render (reference `run()`): rcfg.num_steps
    uniform samples between the AABB's near and far, optionally upsampled
    by rcfg.upsample_steps importance samples merged in depth order.

    jitter: (N, num_steps) uniform draws that perturb each sample by
    (jitter - 0.5) sample spacings (the reference's perturb), or None;
    u: (N, upsample_steps) draws for sample_pdf, or None for its midpoints.
    bg_color: scalar, (3,) or (N, 3); crop_aabb: a (6,) tensor that narrows
    [near, far], or None. Returns {"image" (N, 3), "depth", "weights_sum"
    (N,)}, differentiable w.r.t. the field and the rays in both modes."""
    n = rays_o.shape[0]
    aabb = aabb_of(field.bound, rays_o.device)
    near, far = near_far_from_aabb(rays_o, rays_d, aabb, rcfg.min_near)
    if crop_aabb is not None:  # reference renderer.py:196-199
        from nerfnav_tpu_torch.ops.marching import crop_near_far

        near, far = crop_near_far(near, far, rays_o, rays_d, crop_aabb)
    t = rcfg.num_steps
    z_vals = near[:, None] + (far - near)[:, None] * linspace(0.0, 1.0, t, rays_o.device)
    # a tensor divisor, so the card's jitter lands where the CPU's does (CUDA
    # divides by a Python scalar as a multiply by its reciprocal)
    sample_dist = (far - near) / device_const(float(t), rays_o.device)
    if jitter is not None:
        z_vals = z_vals + (jitter - 0.5) * sample_dist[:, None]

    def eval_density(z):
        xyz = _clip(rays_o[:, None, :] + rays_d[:, None, :] * z[..., None],
                    -field.bound, field.bound)
        sigma, geo = field.density_fn(xyz.reshape(-1, 3))
        return sigma.reshape(z.shape), geo.reshape(*z.shape, -1)

    sigmas, geo_feats = eval_density(z_vals)
    if rcfg.upsample_steps > 0:
        # importance samples from the coarse weights, with no derivative in
        # either mode through the proposal (detach, not no_grad, which
        # leaves forward-mode tangents on)
        zc, sc = z_vals.detach(), sigmas.detach()
        deltas_c = torch.cat([torch.diff(zc, dim=-1), sample_dist.detach()[:, None]], dim=-1)
        _, _, _, w_coarse = composite(sc, torch.zeros((*sc.shape, 3), device=sc.device),
                                      deltas_c, zc, field.density_scale)
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        bins = torch.cat([near[:, None], mids, far[:, None]], dim=-1).detach()
        new_z = sample_pdf(bins, w_coarse, rcfg.upsample_steps, u).detach()
        new_sigmas, new_geo = eval_density(new_z)
        z_all = torch.cat([z_vals, new_z], dim=-1)
        order = torch.argsort(z_all, dim=-1, stable=True)
        z_vals = torch.gather(z_all, -1, order)
        sigmas = torch.gather(torch.cat([sigmas, new_sigmas], dim=-1), -1, order)
        geo_all = torch.cat([geo_feats, new_geo], dim=-2)
        geo_feats = torch.gather(geo_all, -2, order[..., None].expand(*order.shape,
                                                                      geo_all.shape[-1]))
        t = t + rcfg.upsample_steps

    deltas = torch.cat([torch.diff(z_vals, dim=-1), sample_dist[:, None]], dim=-1)
    dirs = _unit(rays_d)[:, None, :].expand(n, t, 3).reshape(-1, 3)
    rgbs = field.color_fn(dirs, geo_feats.reshape(n * t, -1)).reshape(n, t, 3)
    image, depth, weights_sum, _ = composite(sigmas, rgbs, deltas, z_vals, field.density_scale)
    bg = _background(field, bg_color, rays_o, rays_d)
    image = _clip(image + (1.0 - weights_sum)[:, None] * bg, 0.0, 1.0)
    return {"image": image, "depth": depth, "weights_sum": weights_sum}


def render_image(field: Field, rcfg: RenderConfig, rays_o, rays_d, bg_color=1.0,
                 chunk=None):
    """render_rays over fixed-size chunks of a frame's rays (the reference's
    staged inference); the last chunk is padded to full size."""
    chunk = chunk or rcfg.max_ray_batch
    n = rays_o.shape[0]
    pad = (-n) % chunk
    if pad:
        rays_o = torch.cat([rays_o, torch.zeros((pad, 3), device=rays_o.device)])
        rays_d = torch.cat([rays_d, torch.full((pad, 3), 1.0 / math.sqrt(3.0),
                                               device=rays_d.device)])
    outs = [render_rays(field, rcfg, rays_o[i : i + chunk], rays_d[i : i + chunk],
                        bg_color=bg_color) for i in range(0, n + pad, chunk)]
    return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}


def render_rays_frozen(field: Field, bound: float, rays_o, rays_d, z, dt, valid,
                       bg_color=1.0):
    """Shade and composite at precomputed sample depths (N, K), the
    march-free half of render_rays_grid: positions o + d z stay
    differentiable w.r.t. the rays while (z, dt, valid) are constants. The
    pose filter's frozen mode marches once per update at the predicted pose
    and shades this fixed lattice every LM iteration."""
    z, dt = z.detach(), dt.detach()
    sigmas, rgbs = _shade_dense(field, rays_o, rays_d, z, valid, bound)
    image, depth, weights_sum, _ = composite(sigmas, rgbs, dt, z, field.density_scale)
    bg = _background(field, bg_color, rays_o, rays_d)
    image = _clip(image + (1.0 - weights_sum)[:, None] * bg, 0.0, 1.0)
    return {"image": image, "depth": depth, "weights_sum": weights_sum}


def render_rays_grid(field: Field, occupancy, mcfg, rays_o, rays_d, key=None,
                     bg_color=1.0, sample_budget=None, crop_aabb=None,
                     sample_groups: int = 1):
    """Occupancy-grid rendering in one shot, the training render.

    March (without gradient, like the reference's stop_gradient), shade the
    (N, K) samples densely or, with `sample_budget` < N*K, only the first
    `sample_budget` valid samples packed ray by ray (the rest are dropped
    tail first), composite, add the background. key: a MarchKey or None;
    bg_color: scalar, (3,) or (N, 3). sample_groups > 1 packs each of that
    many equal blocks of rays into sample_budget / sample_groups slots of
    its own (a mesh of that many ranks packs so, one block each). Returns
    {"image", "depth", "weights_sum", "n_samples"}; n_samples is the valid
    count before the budget, a 0-d tensor."""
    from nerfnav_tpu_torch.ops.marching import march

    n = rays_o.shape[0]
    # detached rays: no derivative of either mode enters the march
    with torch.no_grad():
        m = march(rays_o.detach(), rays_d.detach(), occupancy, mcfg, key=key,
                  crop_aabb=crop_aabb)
    z, dt, valid = m["z"], m["dt"], m["valid"]
    k = z.shape[1]
    n_samples = valid.sum()
    if sample_budget is not None and sample_budget < n * k:
        sigmas, rgbs = _shade_packed(field, rays_o, rays_d, z, valid,
                                     sample_budget, mcfg.bound, groups=sample_groups)
    else:
        sigmas, rgbs = _shade_dense(field, rays_o, rays_d, z, valid, mcfg.bound)
    image, depth, weights_sum, _ = composite(sigmas, rgbs, dt, z, field.density_scale)
    bg = _background(field, bg_color, rays_o, rays_d)
    image = _clip(image + (1.0 - weights_sum)[:, None] * bg, 0.0, 1.0)
    return {"image": image, "depth": depth, "weights_sum": weights_sum,
            "n_samples": n_samples}


def _shade_dense(field: Field, rays_o, rays_d, z, valid, bound: float):
    """Field over the full (N, K) lattice: density at o + d z (invalid slots
    zeroed), color from each ray's direction encoded once."""
    n, k = z.shape
    # _clip: the frozen filter path takes forward-mode derivatives here
    pos = _clip(rays_o[:, None, :] + rays_d[:, None, :] * z[..., None], -bound, bound)
    sigmas, geo = field.density_fn(pos.reshape(-1, 3))
    sigmas = torch.where(valid.reshape(-1), sigmas, 0.0).reshape(n, k)
    if field.encode_dir_fn is None:  # analytic fields: color from directions
        dirs = _unit(rays_d)[:, None, :].expand(n, k, 3).reshape(-1, 3)
        return sigmas, field.color_fn(dirs, geo).reshape(n, k, 3)
    hd = field.encode_dir_fn(_unit(rays_d))
    e = hd.shape[-1]
    rgbs = field.color_enc_fn(hd[:, None, :].expand(n, k, e).reshape(-1, e), geo)
    return sigmas, rgbs.reshape(n, k, 3)


def _pack_indices(valid, budget: int):
    """Packed slot -> (ray r, in-ray position j, slot in use) for a per-ray
    prefix mask (..., N, K): (..., budget) int64, int64, bool, each leading
    index packed on its own. Each ray's id and its segment start are written
    at the start, and a running max (cummax) fills each segment; a ray with
    no samples shares its start with the next ray, which the max resolves to
    the later one."""
    *lead, n, _ = valid.shape
    dev = valid.device
    counts = valid.sum(dim=-1)
    offsets = torch.cumsum(counts, -1) - counts
    total = offsets[..., -1:] + counts[..., -1:]
    at = torch.clamp(offsets, max=budget)  # starts past the budget drop
    seg_ray = torch.zeros((*lead, budget + 1), dtype=torch.int64, device=dev)
    seg_ray.scatter_reduce_(-1, at, torch.arange(n, device=dev).expand_as(at), "amax")
    seg_off = torch.zeros((*lead, budget + 1), dtype=torch.int64, device=dev)
    seg_off.scatter_reduce_(-1, at, offsets, "amax")
    r = torch.cummax(seg_ray[..., :budget], -1).values
    p = torch.arange(budget, device=dev)
    return r, p - torch.cummax(seg_off[..., :budget], -1).values, p < total


def _shade_packed(field: Field, rays_o, rays_d, z, valid, budget: int, bound: float,
                  groups: int = 1):
    """Field over a packed buffer of the first `budget` valid samples (valid
    is a per-ray prefix), scattered back into the dense (N, K) layout for the
    unchanged composite. A packed sample whose dense slot is invalid shades
    nothing (the reference's defence against a mask that is no prefix).

    groups > 1 cuts the rays into `groups` equal blocks, each packing its
    own first budget / groups valid samples (reference renderer.py:402-470):
    a block's tail drops where the global packing would have kept it."""
    n, k = z.shape
    assert n % groups == 0 and budget % groups == 0, (n, budget, groups)
    ng = n // groups
    r, j, pvalid = _pack_indices(valid.reshape(groups, ng, k) if groups > 1 else valid,
                                 budget // groups)
    flat = torch.clamp(r * k + j, 0, ng * k - 1)
    if groups > 1:  # block-local slots to global rays and dense slots
        block = torch.arange(groups, device=z.device)[:, None]
        flat = (flat + block * (ng * k)).reshape(-1)
        r = (r + block * ng).reshape(-1)
        pvalid = pvalid.reshape(-1)
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

    # once per chunk, after the rounds
    bg = _background(field, bg_color, rays_o, rays_d)
    image = image + (1.0 - wsum)[:, None] * bg
    return {"image": image.clamp(0.0, 1.0), "depth": depth, "weights_sum": wsum}
