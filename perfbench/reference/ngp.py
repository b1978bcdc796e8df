"""Plain PyTorch reference of an Instant-NGP NeRF field and its training step.

Written from the published description (Mueller et al. 2022, arXiv
2201.05989; torch-ngp's `nerf/network.py`, `nerf/renderer.py` and
`raymarching`) and the configuration file, not from the program: it imports
nothing of nerfnav_tpu_torch. A configuration is the dict of
`perfbench/configs/<name>.json`.

- The field: a multiresolution hash grid (one table row per lattice vertex,
  trilinear weights, torch-ngp's spatial hash where a level's lattice does
  not fit its table), real spherical harmonics of degree 4 for the view
  direction, a bias-free sigma MLP whose first output is the log-density
  (`trunc_exp`) and the rest the geometry features, and a bias-free colour
  MLP with a sigmoid output.
- Precision: `PRECISIONS` names how the MLPs and the tables compute. The
  configuration states bf16 MLP operands with f32 accumulation and f32
  tables; the control of the correctness check computes one step lower
  (fp8 e4m3 operands with a per-tensor scale, bf16 tables).
- Rendering: rays from pixel indices, the AABB slab test, alpha compositing
  with an exclusive transmittance, the background mixed in behind.
- The occupancy march for bound <= 1 (one cascade): the two-phase march of
  the configuration (a coarse ladder of `coarse_step_mult` fine steps
  against the max-pooled coarse grid, `coarse_segments` segments kept,
  subdivided into fine steps against the fine grid, `samples_per_ray`
  samples kept, each spread by a stride when a ray has more), with every
  occupancy test exact.
- The density sweep of the occupancy grid, the mark of cells no training
  camera sees, and Adam with the exponential learning-rate schedule.
"""

from dataclasses import dataclass
import math

import torch

SQRT3 = math.sqrt(3.0)
HASH_PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Precision:
    """How the field computes: the MLP operands ("float32", "bfloat16" or
    "fp8": e4m3 with a per-tensor scale to its largest value) and the hash
    tables' compute dtype. A gradient is rounded to the operand's precision
    as a bf16 operand's cotangent is."""
    mlp: str
    tables: torch.dtype


PRECISIONS = {
    "config": Precision("bfloat16", torch.float32),
    "control": Precision("fp8", torch.bfloat16),
}


# ----------------------------------------------------------------- field
def level_resolutions(c) -> list:
    """Each level's lattice resolution: base * scale^l, rounded up, with
    scale chosen so the last level reaches max_resolution * bound."""
    levels, base = c["grid_levels"], c["grid_base_resolution"]
    desired = int(c["grid_max_resolution"] * c["bound"])
    scale = 2.0 ** (math.log2(desired / base) / (levels - 1))
    return [int(math.ceil(base * scale**lv)) for lv in range(levels)]


def level_rows(c) -> list:
    """Table rows per level: one per lattice vertex while they fit in
    2^log2_hashmap_size, else that many; rounded up to a multiple of 8."""
    cap = 2 ** c["grid_log2_hashmap_size"]
    return [int(math.ceil(min(cap, (r + 1) ** 3) / 8) * 8) for r in level_resolutions(c)]


def _corner_rows(corners, r: int, c):
    """(..., 3) int64 lattice vertices -> table rows: the dense index x, y,
    z (x most significant) where the lattice fits, else the xor of each
    coordinate times its prime, modulo 2^32, masked to the table."""
    cap = 2 ** c["grid_log2_hashmap_size"]
    x, y, z = corners[..., 0], corners[..., 1], corners[..., 2]
    if (r + 1) ** 3 <= cap:
        return (x * (r + 1) + y) * (r + 1) + z
    h = (x * HASH_PRIMES[0]) & U32
    h = h ^ ((y * HASH_PRIMES[1]) & U32)
    h = h ^ ((z * HASH_PRIMES[2]) & U32)
    return h & (cap - 1)


def hash_encode(tables, x, c, table_dtype=torch.float32):
    """x (N, 3) in [-bound, bound] -> (N, levels * level_dim) features;
    points outside the cube get zeros."""
    bound = c["bound"]
    # a tensor divisor gives the same quotient on every device
    u = (x.float() + bound) / torch.full((), 2.0 * bound, device=x.device)
    inside = ((u >= 0.0) & (u <= 1.0)).all(dim=-1)
    u = u.clamp(0.0, 1.0)
    bits = torch.tensor([[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)],
                        device=x.device)
    feats = []
    for lv, r in enumerate(level_resolutions(c)):
        p = u * r
        cell = torch.floor(p).clamp(0, r - 1)
        frac = p - cell
        corners = cell.long()[:, None, :] + bits[None]
        w = torch.where(bits[None] > 0, frac[:, None, :], 1.0 - frac[:, None, :]).prod(-1)
        rows = tables[lv].to(table_dtype)[_corner_rows(corners, r, c)]
        feats.append((rows.float() * w[..., None]).sum(dim=1))
    return torch.cat(feats, dim=-1) * inside[:, None]


def sh4(d):
    """Real spherical harmonics of degree 4 (16 values) of unit directions,
    torch-ngp's shencoder constants."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y,
        -1.0925484305920792 * y * z,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * xx - 0.54627421529603959 * yy,
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


class _RoundFP8(torch.autograd.Function):
    """Round to float8 e4m3 at a per-tensor scale (its largest magnitude to
    448); the gradient passes straight through."""

    @staticmethod
    def forward(ctx, t):
        scale = 448.0 / t.detach().abs().amax().clamp(min=1e-30)
        return (t * scale).to(torch.float8_e4m3fn).float() / scale

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBF16(torch.autograd.Function):
    """Round to bfloat16; the gradient is rounded to bfloat16 too, as a
    bf16 operand's cotangent is."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def _operand(t, mlp: str):
    if mlp == "float32":
        return t
    return _RoundBF16.apply(t) if mlp == "bfloat16" else _RoundFP8.apply(t)


def mlp(x, weights, prec: Precision):
    """Bias-free MLP, ReLU between layers, no output activation: operands
    rounded to prec.mlp, products accumulated in float32 (TF32 is off while
    the reference runs)."""
    h = x
    for i, w in enumerate(weights):
        h = _operand(h, prec.mlp) @ _operand(w, prec.mlp)
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


class TruncExp(torch.autograd.Function):
    """torch-ngp's density activation: exp, with the derivative's exponent
    clamped to [-15, 15]."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def density(params, x, c, prec: Precision):
    """(sigma (N,), geometry features (N, geo_feat_dim))."""
    h = mlp(hash_encode(params["encoder"], x, c, prec.tables), params["sigma_net"], prec)
    return TruncExp.apply(h[:, 0]), h[:, 1:]


def color(params, dirs, geo, c, prec: Precision):
    """rgb (N, 3) from unit directions and geometry features."""
    return torch.sigmoid(mlp(torch.cat([sh4(dirs), geo], dim=-1), params["color_net"], prec))


# ------------------------------------------------------------- rendering
def pixel_rays(pose, intrinsics, W: int, inds):
    """Rays through the centres of flat pixel indices: camera-frame
    directions ((i + 0.5 - cx) / fx, (j + 0.5 - cy) / fy, 1), normalized and
    rotated by the pose; origins at the camera."""
    j, i = inds // W, inds % W
    fx, fy, cx, cy = intrinsics
    d = torch.stack([(i.float() + 0.5 - cx) / fx, (j.float() + 0.5 - cy) / fy,
                     torch.ones_like(i, dtype=torch.float32)], dim=-1)
    d = d / torch.sqrt((d * d).sum(dim=-1, keepdim=True))
    d = d @ pose[:3, :3].T
    return pose[:3, 3].expand(d.shape), d


def near_far(o, d, bound: float, min_near: float):
    """Slab test against [-bound, bound]^3; near is at least min_near and
    a ray that misses the cube gets far == near."""
    inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    t0, t1 = (-bound - o) * inv, (bound - o) * inv
    near = torch.minimum(t0, t1).amax(dim=-1).clamp(min=min_near)
    far = torch.maximum(torch.maximum(t0, t1).amin(dim=-1), near)
    return near, far


def composite(sigma, rgb, dt, density_scale: float):
    """Alpha compositing along the samples: (image (N, 3), weights sum)."""
    alpha = 1.0 - torch.exp(-dt * density_scale * sigma)
    trans = torch.cumprod(1.0 - alpha + 1e-15, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    w = alpha * trans
    return (w[..., None] * rgb).sum(dim=-2), w.sum(dim=-1)


def shade(params, o, d, z, valid, c, prec: Precision):
    """The field at o + d z (N, K) (clamped into the cube), density zero at
    invalid samples: (sigma (N, K), rgb (N, K, 3))."""
    n, k = z.shape
    b = c["bound"]
    pos = (o[:, None, :] + d[:, None, :] * z[..., None]).clamp(-b, b).reshape(-1, 3)
    sigma, geo = density(params, pos, c, prec)
    sigma = torch.where(valid.reshape(-1), sigma, 0.0).reshape(n, k)
    dirs = (d / torch.sqrt((d * d).sum(-1, keepdim=True)))[:, None, :].expand(n, k, 3)
    return sigma, color(params, dirs.reshape(-1, 3), geo, c, prec).reshape(n, k, 3)


def point_budget(c, mean_count: float):
    """The samples a training step shades at most: the smallest of the
    configuration's fractions (below 1) of num_rays x samples_per_ray that
    covers point_budget_margin x the mean count of valid samples a step
    (the running mean as of the last sweep); None (every sample) without a
    mean count or where no fraction covers it."""
    if mean_count <= 0:
        return None
    nk = c["num_rays"] * c["samples_per_ray"]
    for frac in sorted(c["point_budget_fracs"]):
        if frac < 1.0 and frac * nk >= c["point_budget_margin"] * mean_count:
            return int(frac * nk)
    return None


def within_budget(valid, budget):
    """valid (N, K) with only the first `budget` valid samples, ray by ray,
    kept (budget None: all)."""
    if budget is None:
        return valid
    return valid & (torch.cumsum(valid.reshape(-1).long(), 0) <= budget).reshape(valid.shape)


def render_samples(params, o, d, z, dt, valid, bg, c, prec: Precision):
    """Image (N, 3) of marched samples over the background bg."""
    sigma, rgb = shade(params, o, d, z, valid, c, prec)
    img, ws = composite(sigma, rgb, dt, c["density_scale"])
    return (img + (1.0 - ws)[:, None] * bg).clamp(0.0, 1.0)


def dense_samples(o, d, jitter, c):
    """The dense path's num_steps samples between near and far, each moved
    by (jitter - 0.5) sample spacings (jitter None: not moved): (z, dt)
    (N, T); the last dt is the spacing."""
    t = c["num_steps"]
    near, far = near_far(o, d, c["bound"], c["min_near"])
    # the fractions i / (t - 1), made on the CPU: the card divides by a
    # number as a multiply by its reciprocal
    s = torch.arange(t - 1, dtype=torch.float32) / (t - 1)
    lin = torch.cat([s, torch.ones(1)]).to(o.device)
    spacing = (far - near) / torch.full((), float(t), device=o.device)
    z = near[:, None] + (far - near)[:, None] * lin
    if jitter is not None:
        z = z + (jitter - 0.5) * spacing[:, None]
    return z, torch.cat([z[:, 1:] - z[:, :-1], spacing[:, None]], dim=-1)


# ------------------------------------------------------------- the march
def march_schedule(c, step: int):
    """(max_steps, dt) of the march at a training step: max_steps divided
    by the anneal multiplier in force (at least 8 steps)."""
    mult = 1
    for threshold, m in c["dt_anneal"]:
        at = threshold * c["iters"] if threshold <= 1.0 else threshold
        if step >= at:
            mult = m
    steps = max(c["max_steps"] // mult, 8) if mult > 1 else c["max_steps"]
    return steps, 2.0 * SQRT3 / steps


def _grid_cells(pos, h: int):
    """(N, T, 3) positions in [-1, 1]^3 -> flat row-major cells of an h^3
    grid (bound <= 1: one cascade spans the cube)."""
    u = (pos * 0.5 + 0.5).clamp(0.0, 1.0 - 1e-6)
    cell = (u * h).long()
    return (cell[..., 0] * h + cell[..., 1]) * h + cell[..., 2]


def _spread(cand, k: int, start):
    """Keep k of each row's True candidates (N, T): with n > k of them,
    every stride-th from `start` (stride = ceil(n / k)). Returns (pos (N, k)
    int64 candidate positions, valid (N, k), stride (N, 1))."""
    n_rows, t = cand.shape
    rank = torch.cumsum(cand.long(), dim=1) - 1
    count = rank[:, -1:] + 1
    stride = ((count + k - 1) // k).clamp(min=1)
    start = start % stride
    keep = cand & ((rank - start) % stride == 0) & (rank >= start)
    slot = torch.where(keep, (rank - start) // stride, k)
    slot = slot.clamp(max=k)
    pos = torch.full((n_rows, k + 1), t - 1, dtype=torch.long, device=cand.device)
    pos.scatter_(1, slot, torch.arange(t, device=cand.device).expand(n_rows, t).contiguous())
    valid = torch.zeros((n_rows, k + 1), dtype=torch.bool, device=cand.device)
    valid.scatter_(1, slot, torch.ones_like(keep))
    return pos[:, :k], valid[:, :k], stride


def march(o, d, occ, c, step: int, u, phase):
    """The training march of a one-cascade grid (bound <= 1) at a step.

    occ: (h^3,) bool fine occupancy, row-major; u (N,) shifts each ray's
    start by u * dt; phase (N, 1) int64 picks the stride phase of a ray with
    more than samples_per_ray fine candidates. Returns (z, dt, valid), each
    (N, samples_per_ray)."""
    if c["bound"] > 1.0:
        raise ValueError("the reference march covers one cascade (bound <= 1)")
    h, f = c["occ_grid_size"], c["occ_coarse_factor"]
    hc, mult = h // f, c["coarse_step_mult"]
    _, dt = march_schedule(c, step)
    base = dt * mult
    near, far = near_far(o, d, c["bound"], c["min_near"])
    near = near + u * dt
    coarse = occ.reshape(hc, f, hc, f, hc, f).amax(dim=(1, 3, 5)).reshape(-1)

    # phase A: coarse segments [z_i, z_i+1) whose either end is occupied
    n_a = int(math.ceil(2.0 * SQRT3 * max(c["bound"], 1.0) / base))
    z_a = near[:, None] + torch.arange(n_a, dtype=torch.float32, device=o.device) * base
    hit = coarse[_grid_cells(o[:, None, :] + d[:, None, :] * z_a[..., None], hc)]
    hit = (hit | torch.cat([hit[:, 1:], torch.zeros_like(hit[:, :1])], 1)) & (z_a < far[:, None])
    seg, seg_ok, seg_stride = _spread(hit, c["coarse_segments"], torch.zeros_like(near).long()[:, None])
    za = torch.where(seg_ok, near[:, None] + seg * base, 0.0)
    dta = torch.where(seg_ok, base * seg_stride.float(), 0.0)

    # phase B: each kept segment in mult fine steps against the fine grid
    sub = dta[:, :, None] / torch.full((), float(mult), device=o.device)
    z_b = (za[:, :, None] + torch.arange(mult, dtype=torch.float32, device=o.device) * sub)
    z_b = z_b.reshape(len(o), -1)
    fine = occ[_grid_cells(o[:, None, :] + d[:, None, :] * z_b[..., None], h)]
    fine = fine & seg_ok.repeat_interleave(mult, dim=1) & (z_b < far[:, None])
    pos, valid, stride = _spread(fine, c["samples_per_ray"], phase)
    z = torch.where(valid, torch.gather(z_b, 1, pos), 0.0)
    sub_b = sub.expand(-1, -1, mult).reshape(len(o), -1)
    return z, torch.where(valid, torch.gather(sub_b, 1, pos) * stride.float(), 0.0), valid


# ------------------------------------------------------ occupancy sweep
def cell_centres(h: int, device):
    """Centres of an h^3 grid's cells in [-1, 1]^3, row-major."""
    idx = torch.arange(h**3, device=device)
    ijk = torch.stack([idx // (h * h), (idx // h) % h, idx % h], dim=-1)
    return (ijk.float() + 0.5) / h * 2.0 - 1.0


def unseen_cells(poses, intrinsics, H: int, W: int, c, chunk: int = 2**17):
    """(h^3,) bool: cells whose centre lies in no training camera's frustum
    (half a pixel of slack, in front of min_near)."""
    h, b = c["occ_grid_size"], min(1.0, c["bound"])
    centres = cell_centres(h, poses.device) * (b - b / h)
    fx, fy = intrinsics[0], intrinsics[1]
    out = []
    for s in range(0, h**3, chunk):
        rel = centres[s:s + chunk, None, :] - poses[None, :, :3, 3]
        rot = poses[None, :, :3, :3]
        cam = (rel[..., 0:1] * rot[:, :, 0, :] + rel[..., 1:2] * rot[:, :, 1, :]
               + rel[..., 2:3] * rot[:, :, 2, :])
        x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
        seen = ((z > c["min_near"]) & (x.abs() * fx < (W / 2 + 0.5) * z.abs())
                & (y.abs() * fy < (H / 2 + 0.5) * z.abs()))
        out.append(~seen.any(dim=-1))
    return torch.cat(out)


@torch.no_grad()
def full_sweep(params, grid, jitter, c, prec: Precision, chunk: int = 2**18):
    """One full density sweep of a one-cascade grid: the density at a
    jittered point of every cell, times density_scale; cells at -1 (unseen)
    stay; the others take max(decayed, new). Returns (grid, occupancy): a
    cell is occupied above min(mean of the clamped grid, density_thresh)."""
    h, b = c["occ_grid_size"], min(1.0, c["bound"])
    half = b / h
    pts = cell_centres(h, grid.device) * (b - half) + (jitter * 2.0 - 1.0) * half
    sig = torch.cat([density(params, pts[s:s + chunk], c, prec)[0]
                     for s in range(0, len(pts), chunk)]) * c["density_scale"]
    new = torch.where(grid >= 0, torch.maximum(grid * c["occ_decay"], sig), grid)
    thresh = new.clamp(min=0.0).mean().clamp(max=c["occ_density_thresh"])
    return new, new > thresh


@torch.no_grad()
def partial_sweep(params, grid, rand_cells, u, jitter, c, prec: Precision,
                  chunk: int = 2**18):
    """One partial density sweep of a one-cascade grid: the cells
    `rand_cells` and as many drawn among the occupied ones (density above 0),
    the k-th occupied cell in row-major order for k = floor(u * their count)
    (`rand_cells` again where none is), each queried at its jittered point
    (`jitter`, one row per queried cell in that order). A cell queried twice
    keeps its larger density; a cell not queried decays; cells at -1 stay.
    Returns (grid, occupancy) as full_sweep does."""
    h, b = c["occ_grid_size"], min(1.0, c["bound"])
    half = b / h
    occupied = torch.nonzero(grid > 0).squeeze(-1)
    if len(occupied):
        k = (u * float(len(occupied))).floor().long().clamp(max=len(occupied) - 1)
        drawn = occupied[k]
    else:
        drawn = rand_cells
    cells = torch.cat([rand_cells, drawn])
    pts = cell_centres(h, grid.device)[cells] * (b - half) + (jitter * 2.0 - 1.0) * half
    sig = torch.cat([density(params, pts[s:s + chunk], c, prec)[0]
                     for s in range(0, len(pts), chunk)]) * c["density_scale"]
    queried = torch.full_like(grid, -1.0).scatter_reduce(0, cells, sig, "amax")
    new = torch.where(grid >= 0, torch.maximum(grid * c["occ_decay"], queried), grid)
    thresh = new.clamp(min=0.0).mean().clamp(max=c["occ_density_thresh"])
    return new, new > thresh


# ---------------------------------------------------------------- Adam
def adam(leaves0, grads_per_step, c, state=None):
    """The leaves after Adam(beta1, beta2, eps) from leaves0 over each
    step's gradients in turn, at lr * 0.1^(t / iters), t counting the steps
    before this one. state: the optimizer's (first moments, second moments,
    steps taken) before the first of them; zeros and 0 without."""
    b1, b2 = c["adam_betas"]
    eps = c["adam_eps"]
    if state is None:
        state = ([torch.zeros_like(p) for p in leaves0],
                 [torch.zeros_like(p) for p in leaves0], 0)
    m, v, t0 = [t.clone() for t in state[0]], [t.clone() for t in state[1]], state[2]
    p = [t.clone() for t in leaves0]
    for t, grads in enumerate(grads_per_step, start=t0):
        lr = c["lr"] * 0.1 ** (t / c["iters"])
        for i, g in enumerate(grads):
            m[i] = b1 * m[i] + (1 - b1) * g
            v[i] = b2 * v[i] + (1 - b2) * g * g
            m_hat = m[i] / (1 - b1 ** (t + 1))
            v_hat = v[i] / (1 - b2 ** (t + 1))
            p[i] = p[i] - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return p


def leaves(params):
    """The parameter tensors in sorted-key order."""
    return [t for k in sorted(params) for t in params[k]]


def with_leaves(params, new):
    """The params dict with its tensors replaced, in leaves() order."""
    it = iter(new)
    return {k: [next(it) for _ in params[k]] for k in sorted(params)}
