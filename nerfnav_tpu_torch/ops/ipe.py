"""mip-NeRF's cone casting and integrated positional encoding.

No counterpart in nerfnav_tpu: written from mip-NeRF (Barron et al. 2021,
arXiv 2103.13415; google/mipnerf `internal/mip.py` and `internal/math.py`).
A pixel is a cone from the camera with base radius `radii` at unit camera
depth; each interval [t0, t1] along a ray is a conical frustum, taken as a
Gaussian with a diagonal covariance, and the encoding is the expected sine
and cosine of each frequency under that Gaussian. Elementwise float32 math;
autograd gives the gradient where one is wanted.
"""

import math

import torch

from nerfnav_tpu_torch.device import device_const

_TRIG_WRAP = 100.0 * math.pi


def cast_cones(t, rays_o, rays_d, radii):
    """Gaussians of the conical frustums between consecutive depths.

    t (N, T+1) sorted depths along rays_d (N, 3), which is not normalised
    (t is in its units); radii (N, 1). Returns (means (N, T, 3), diagonal
    covariances (N, T, 3)): mip.py `cast_rays` with `ray_shape="cone"` and
    `conical_frustum_to_gaussian(stable=True)`."""
    t0, t1 = t[:, :-1], t[:, 1:]
    mu = 0.5 * (t0 + t1)
    hw = 0.5 * (t1 - t0)
    mu2, hw2 = mu * mu, hw * hw
    den = 3.0 * mu2 + hw2
    t_mean = mu + (2.0 * mu * hw2) / den
    t_var = hw2 / 3.0 - (4.0 / 15.0) * ((hw2 * hw2 * (12.0 * mu2 - hw2)) / (den * den))
    r_var = radii * radii * (mu2 / 4.0 + (5.0 / 12.0) * hw2 - (4.0 / 15.0) * (hw2 * hw2) / den)
    d2 = rays_d * rays_d
    null = 1.0 - d2 / torch.clamp(d2.sum(dim=-1, keepdim=True), min=1e-10)
    means = rays_o[:, None, :] + rays_d[:, None, :] * t_mean[..., None]
    covs = t_var[..., None] * d2[:, None, :] + r_var[..., None] * null[:, None, :]
    return means, covs


def _safe_sin(x):
    """sin of x wrapped into [0, 100 pi) where |x| >= 100 pi (math.py
    `safe_sin`)."""
    return torch.sin(torch.where(x.abs() < _TRIG_WRAP, x, torch.remainder(x, _TRIG_WRAP)))


def _scales(min_deg: int, max_deg: int, device):
    return device_const([2.0**i for i in range(min_deg, max_deg)], device)


def integrated_pos_enc(means, covs, min_deg: int, max_deg: int):
    """(..., 3) means and diagonal covariances -> (..., 6 (max_deg -
    min_deg)) features: [sin(y) w, sin(y + pi / 2) w] with y the means
    times 2^l (degree-major, xyz-minor) and w = exp(-var 4^l / 2), no
    identity term (mip.py `integrated_pos_enc(diag=True)`)."""
    s = _scales(min_deg, max_deg, means.device)
    shape = (*means.shape[:-1], -1)
    y = (means[..., None, :] * s[:, None]).reshape(shape)
    w = torch.exp(-0.5 * (covs[..., None, :] * (s * s)[:, None]).reshape(shape))
    return torch.cat([_safe_sin(y) * w, _safe_sin(y + 0.5 * math.pi) * w], dim=-1)


def pos_enc(x, min_deg: int, max_deg: int):
    """(..., 3) -> (..., 3 + 6 (max_deg - min_deg)): x, then sin(x 2^l) and
    sin(x 2^l + pi / 2) (mip.py `pos_enc(append_identity=True)`)."""
    s = _scales(min_deg, max_deg, x.device)
    xb = (x[..., None, :] * s[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))], dim=-1)
