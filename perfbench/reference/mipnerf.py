"""Plain PyTorch reference of mip-NeRF's field, two-level render, loss,
gradients and Adam steps.

Written from the published description and code (Barron et al. 2021, arXiv
2103.13415; google/mipnerf `internal/mip.py`, `internal/math.py`,
`internal/models.py`, `internal/datasets.py` and `train.py`) and the
configuration file, not from the program: it imports nothing of
nerfnav_tpu_torch. A configuration is the dict of
`perfbench/configs/mipnerf-blender.json`. Float32 throughout, TF32 off
while it runs (`no_tf32`), no kernels, computed in blocks of rays.

Parameters come in the program's layout, lists of [weight (in, out), bias]
pairs under "trunk" (the net_depth layers), "sigma", "bottleneck", "view"
and "rgb"; `leaves` orders them by key.

Departures, each written where it is made:
- the camera: the port's pinhole, directions ((i + 0.5 - cx) / fx, (j + 0.5
  - cy) / fy, 1) (mipnerf's Blender camera looks along -z with y up); t is
  depth along the optical axis in both;
- the loss: the mean over rays and channels of each level's squared error;
  mipnerf's `train.py` divides the sum over rays and channels by the sum of
  the per-ray `lossmult` (ones), three times this, a scale Adam divides out
  (but for its eps);
- `PRECISIONS`: how the matmuls round their operands. The configuration
  states bf16 operands with float32 products, sums and results (a TPU's
  default precision, which mipnerf ran at), forward and backward; the
  control of the correctness check computes one step lower (fp8 e4m3
  operands at a per-tensor scale).
"""

from contextlib import contextmanager
import math

import torch

PRECISIONS = {"config": "bfloat16", "control": "fp8", "exact": "float32"}
F32_EPS = float(torch.finfo(torch.float32).eps)


@contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def leaves(params):
    return [t for k in sorted(params) for t in params[k]]


def with_leaves(params, new):
    it = iter(new)
    return {k: [next(it) for _ in params[k]] for k in sorted(params)}


# ------------------------------------------------------------ precision
def _round(t, prec: str):
    """t rounded to an operand of precision prec, returned in float32."""
    if prec == "float32":
        return t
    if prec == "bfloat16":
        return t.to(torch.bfloat16).float()
    scale = 448.0 / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class _Dense(torch.autograd.Function):
    """x @ w + b with each product's operands rounded to prec: the forward,
    and the backward's two products (the output gradient rounded too); the
    bias and the sums in float32."""

    @staticmethod
    def forward(ctx, x, w, b, prec):
        ctx.prec = prec
        ctx.save_for_backward(x, w)
        return _round(x, prec) @ _round(w, prec) + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gr = _round(g, ctx.prec)
        gx = gr @ _round(w, ctx.prec).t() if ctx.needs_input_grad[0] else None
        return gx, _round(x, ctx.prec).t() @ gr, g.sum(dim=0), None


def dense(x, w, b, prec):
    return _Dense.apply(x, w, b, prec)


# ----------------------------------------------------------------- rays
def cone_rays(pose, intrinsics, H: int, W: int, inds):
    """(origins, directions at unit camera depth, radii (n, 1)) of flat
    pixel indices: mipnerf `_generate_rays` on the port's camera. The
    radius is 2 / sqrt(12) times the distance between a pixel's direction
    and the next row's; the last row takes the distance of rows H - 3 and
    H - 2, as mipnerf pads its H - 1 row distances with the second last."""
    j, i = (inds // W).float(), (inds % W).float()
    fx, fy, cx, cy = intrinsics

    def world(rows):
        cam = torch.stack([(i + 0.5 - cx) / fx, (rows + 0.5 - cy) / fy, torch.ones_like(i)], -1)
        return (cam[:, None, :] * pose[:3, :3]).sum(dim=-1)

    d = world(j)
    r0 = torch.where(j == H - 1, j - 2.0, j)
    dx = torch.sqrt(((world(r0) - world(r0 + 1.0)) ** 2).sum(dim=-1))
    return pose[:3, 3].expand(d.shape), d, dx[:, None] * 2.0 / math.sqrt(12.0)


def coarse_edges(n: int, jitter, c, device):
    """The first level's num_samples + 1 depths on [near, far], each moved
    within its stratum by jitter (N, num_samples + 1) uniform draws (None:
    evenly spaced)."""
    s = c["num_samples"]
    lin = torch.cat([torch.arange(s, dtype=torch.float32) / s, torch.ones(1)]).to(device)
    t = c["near"] * (1.0 - lin) + c["far"] * lin
    if jitter is None:
        return t.expand(n, s + 1)
    mids = 0.5 * (t[1:] + t[:-1])
    lower, upper = torch.cat([t[:1], mids]), torch.cat([mids, t[-1:]])
    return lower + (upper - lower) * jitter


# ------------------------------------------------------- the encodings
def cast(t, o, d, radii):
    """Means and diagonal covariances (N, T, 3) of the conical frustums
    between consecutive depths t (N, T+1) (mip.py
    `conical_frustum_to_gaussian(stable=True)` and `lift_gaussian`)."""
    t0, t1 = t[:, :-1], t[:, 1:]
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw**2) / (3 * mu**2 + hw**2)
    t_var = (hw**2) / 3 - (4 / 15) * ((hw**4 * (12 * mu**2 - hw**2)) / (3 * mu**2 + hw**2) ** 2)
    r_var = radii**2 * ((mu**2) / 4 + (5 / 12) * hw**2 - 4 / 15 * (hw**4) / (3 * mu**2 + hw**2))
    mean = o[:, None, :] + d[:, None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp((d**2).sum(dim=-1, keepdim=True), min=1e-10)
    null = 1 - d**2 / d_mag_sq
    cov = t_var[..., None] * (d**2)[:, None, :] + r_var[..., None] * null[:, None, :]
    return mean, cov


def safe_sin(x):
    t = 100 * math.pi
    return torch.sin(torch.where(x.abs() < t, x, torch.remainder(x, t)))


def ipe(mean, cov, c):
    """mip.py `integrated_pos_enc`: expected sin of the frequencies 2^l, l
    in [min_deg_point, max_deg_point), of the Gaussians (degree-major,
    xyz-minor; the sines, then the shifted sines)."""
    scales = torch.tensor([2.0**i for i in range(c["min_deg_point"], c["max_deg_point"])],
                          device=mean.device)
    shape = (*mean.shape[:-1], -1)
    y = (mean[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (cov[..., None, :] * scales[:, None] ** 2).reshape(shape)
    x = torch.cat([y, y + 0.5 * math.pi], dim=-1)
    return torch.exp(-0.5 * torch.cat([y_var] * 2, dim=-1)) * safe_sin(x)


def pos_enc(x, max_deg: int):
    """mip.py `pos_enc(min_deg=0, append_identity=True)`."""
    scales = torch.tensor([2.0**i for i in range(max_deg)], device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))], dim=-1)


# --------------------------------------------------------------- the MLP
def mlp(params, x, cond, c, prec):
    """models.py `MLP`: (raw rgb (N, T, 3), raw density (N, T)) at the
    features x (N, T, F) and the per-ray condition cond (N, C)."""
    n, t = x.shape[:2]
    inputs = x.reshape(n * t, -1)
    h = inputs
    trunk = params["trunk"]
    for i in range(c["net_depth"]):
        h = torch.relu(dense(h, trunk[2 * i], trunk[2 * i + 1], prec))
        if i % c["skip_layer"] == 0 and i > 0:
            h = torch.cat([h, inputs], dim=-1)
    raw_density = dense(h, *params["sigma"], prec)
    bottleneck = dense(h, *params["bottleneck"], prec)
    cond = cond[:, None, :].expand(n, t, cond.shape[-1]).reshape(n * t, -1)
    v = torch.relu(dense(torch.cat([bottleneck, cond], dim=-1), *params["view"], prec))
    raw_rgb = dense(v, *params["rgb"], prec)
    return raw_rgb.reshape(n, t, 3), raw_density.reshape(n, t)


# ------------------------------------------------------------ rendering
def volumetric_rendering(rgb, density, t, d, bg):
    """mip.py `volumetric_rendering` over bg: (image (N, 3), weights)."""
    delta = (t[:, 1:] - t[:, :-1]) * torch.linalg.norm(d[:, None, :], dim=-1)
    dd = density * delta
    alpha = 1 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[:, :1]), torch.cumsum(dd[:, :-1], -1)], -1))
    w = alpha * trans
    return (w[..., None] * rgb).sum(dim=-2) + (1.0 - w.sum(dim=-1))[:, None] * bg, w


def sorted_piecewise_constant_pdf(bins, weights, num_samples: int, u):
    """math.py `sorted_piecewise_constant_pdf`, its mask over the CDF
    included; u (N, num_samples) uniform draws in [0, 1) (None: the evenly
    spaced levels)."""
    eps = 1e-5
    weight_sum = weights.sum(dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1)
    n = cdf.shape[0]
    cdf = torch.cat([torch.zeros((n, 1), device=cdf.device), cdf,
                     torch.ones((n, 1), device=cdf.device)], dim=-1)
    s = 1 / num_samples
    if u is None:
        u = torch.linspace(0.0, 1.0 - F32_EPS, num_samples, device=cdf.device).expand(n, -1)
    else:
        u = torch.arange(num_samples, dtype=torch.float32, device=cdf.device) * s \
            + u * (s - F32_EPS)
        u = torch.clamp(u, max=1.0 - F32_EPS)
    mask = u[..., None, :] >= cdf[..., :, None]

    def find_interval(x):
        x0 = torch.where(mask, x[..., None], x[..., :1, None]).amax(dim=-2)
        x1 = torch.where(~mask, x[..., None], x[..., -1:, None]).amin(dim=-2)
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0), 0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample(t, weights, u, c):
    """mip.py `resample_along_rays` (stop_grad): the blurred weights, then
    t.shape[-1] new depths."""
    with torch.no_grad():
        w_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
        w_max = torch.maximum(w_pad[..., :-1], w_pad[..., 1:])
        w = 0.5 * (w_max[..., :-1] + w_max[..., 1:]) + c["resample_padding"]
        return sorted_piecewise_constant_pdf(t, w, t.shape[-1], u)


def level(params, t, o, d, radii, cond, bg, c, prec):
    """One level: (image (N, 3), weights (N, T)); the density is
    jax.nn.softplus, log(1 + e^x)."""
    raw_rgb, raw_density = mlp(params, ipe(*cast(t, o, d, radii), c), cond, c, prec)
    rgb = torch.sigmoid(raw_rgb) * (1 + 2 * c["rgb_padding"]) - c["rgb_padding"]
    density = torch.logaddexp(raw_density + c["density_bias"],
                              torch.zeros((), device=raw_density.device))
    return volumetric_rendering(rgb, density, t, d, bg)


def render(params, o, d, radii, jitter, u, bg, c, prec):
    """models.py `MipNerfModel` (no density noise): ([each level's image],
    [each level's depths], [each level's weights])."""
    cond = pos_enc(d / torch.linalg.norm(d, dim=-1, keepdim=True), c["deg_view"])
    t = coarse_edges(len(o), jitter, c, o.device)
    images, ts, ws = [], [], []
    for lv in range(c["num_levels"]):
        if lv:
            t = resample(t, ws[-1], u, c)
        img, w = level(params, t, o, d, radii, cond, bg, c, prec)
        images.append(img)
        ts.append(t)
        ws.append(w)
    return images, ts, ws


def loss_and_grads(params, o, d, radii, jitter, u, bg, gt, c, prec, block: int = 512):
    """The loss (coarse_loss_mult x the mean squared error of every level
    but the last, plus the last's) of N rays and its gradient per leaf,
    computed block by block (a block's part of each mean is its sum over
    N). Returns (loss, grads, [each level's depths], [each level's
    weights])."""
    n = len(o)
    total, grads = 0.0, None
    ts, ws = [[] for _ in range(c["num_levels"])], [[] for _ in range(c["num_levels"])]
    with no_tf32():
        for s in range(0, n, block):
            sl = slice(s, s + block)
            p = with_leaves(params, [t.detach().requires_grad_() for t in leaves(params)])
            images, t_lv, w_lv = render(p, o[sl], d[sl], radii[sl], None if jitter is None
                                     else jitter[sl], None if u is None else u[sl],
                                     bg if bg.dim() < 2 else bg[sl], c, prec)
            errs = [((img - gt[sl]) ** 2).sum() / (3 * n) for img in images]
            loss = c["coarse_loss_mult"] * sum(errs[:-1]) + errs[-1]
            g = torch.autograd.grad(loss, leaves(p))
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            total += float(loss.detach())
            for lv in range(c["num_levels"]):
                ts[lv].append(t_lv[lv].detach())
                ws[lv].append(w_lv[lv].detach())
    return total, grads, [torch.cat(t) for t in ts], [torch.cat(w) for w in ws]


# --------------------------------------------------------------- Adam
def lr(step: int, c) -> float:
    """train.py `learning_rate_decay` at 1-based step `step`."""
    delay = c["lr_delay_mult"] + (1 - c["lr_delay_mult"]) * math.sin(
        0.5 * math.pi * min(max(step / c["lr_delay_steps"], 0.0), 1.0))
    t = min(max(step / c["max_steps"], 0.0), 1.0)
    return delay * math.exp(math.log(c["lr_init"]) * (1 - t) + math.log(c["lr_final"]) * t)


def adam(leaves0, grads_per_step, c, state=None):
    """flax.optim.Adam(beta1, beta2, eps) from leaves0 over each step's
    gradients; state: (first moments, second moments, steps taken) before
    them. The step count t (from 1) gives the rate and the bias
    corrections."""
    b1, b2 = c["adam_betas"]
    eps = c["adam_eps"]
    if state is None:
        state = ([torch.zeros_like(p) for p in leaves0],
                 [torch.zeros_like(p) for p in leaves0], 0)
    m, v, t0 = [t.clone() for t in state[0]], [t.clone() for t in state[1]], state[2]
    p = [t.clone() for t in leaves0]
    for t, grads in enumerate(grads_per_step, start=t0 + 1):
        rate = lr(t, c)
        for i, g in enumerate(grads):
            m[i] = b1 * m[i] + (1 - b1) * g
            v[i] = b2 * v[i] + (1 - b2) * g * g
            p[i] = p[i] - rate * (m[i] / (1 - b1**t)) / (torch.sqrt(v[i] / (1 - b2**t)) + eps)
    return p
