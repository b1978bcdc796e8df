"""Occupancy-grid ray marching: the block-packed two-phase marcher.

Counterpart of nerfnav_tpu/ops/marching.py, restricted to the branches the
eval render and the train step run: `march_rays_block` with the uniform
(dt_gamma == 0) phase-A ladder, normalized (eval) or fixed (training), or the
static gamma ladder (dt_gamma > 0), beam-shared phase A (MarchConfig.beam > 1)
and the exact phase B, without or with a march key (random start, stratified
or per-ray-hash stride phase), optionally inside a crop AABB.

Phase A walks a per-ray ladder of coarse segments against the block-packed
coarse occupancy table and keeps the first K_A occupied segments; phase B
subdivides them at dt_min (under dt_gamma, at each segment's own step)
against the fine block table and keeps the first K occupied samples. Outputs
(z, dt, valid), each (N, K), match the reference exactly: valid bit for bit,
z/dt to float32 rounding.

JAX draws a march's randomness from its key; here it is a `MarchKey` of
tensors (`draw_march_key` draws one from a torch.Generator), so a test can
inject the JAX draws. The other marchers (byte bitfields), the phase-A0
prefilter, first-K and proxy termination and depth windows raise
NotImplementedError (ROADMAP A6). Its CUDA kernel is ROADMAP B2.
"""

from dataclasses import dataclass, replace
from functools import cached_property
import math
from typing import NamedTuple

import numpy as np
import torch

from nerfnav_tpu_torch.device import device_const, unported
from nerfnav_tpu_torch.ops.morton import (
    block_bit_lookup, block_size_of, pack_blocks, unpack_blocks,
)

_SQRT3 = math.sqrt(3.0)
_U32 = 0xFFFFFFFF
_HASH_PRIMES = (2654435761, 805459861, 3674653429)


class MarchKey(NamedTuple):
    """The random draws of one keyed march: u (N,) uniform in [0, 1) shifts
    each ray's start by u * dt_min; phase (N, 1) int64 raw draws in
    [0, 2^30) pick the stride phase of an overflowing ray (phase % stride).
    The "ray_hash" stride phase ignores `phase`."""
    u: torch.Tensor
    phase: torch.Tensor


def draw_march_key(generator, n: int, device) -> MarchKey:
    """A MarchKey for n rays from a torch.Generator on `device`."""
    return MarchKey(
        u=torch.rand((n,), generator=generator, device=device),
        phase=torch.randint(0, 2**30, (n, 1), generator=generator, device=device))


@dataclass(frozen=True)
class MarchConfig:
    """Field for field the reference's MarchConfig (see its docstrings)."""
    bound: float = 1.0
    grid_size: int = 128
    max_steps: int = 1024
    samples_per_ray: int = 64
    dt_gamma: float = 0.0
    min_near: float = 0.2
    coarse_factor: int = 4
    coarse_step_mult: int = 8
    coarse_segments: int = 16
    coarse_normalized: bool = True
    coarse_anchors: int = 3
    proxy_terminate: bool = False
    proxy_thresh: float = 1e-6
    first_k: bool = False
    first_k_frac: float = 0.75
    coarse_first_k: bool = False
    t_a0_steps: int = 0
    phase_a_group: int = 0
    stride_phase: str = "random"
    gamma_span: float = 0.0
    beam: int = 1
    a0_segments: int = 0

    @cached_property
    def cascades(self) -> int:
        return 1 + math.ceil(math.log2(max(self.bound, 1.0)))

    @cached_property
    def dt_min(self) -> float:
        return 2.0 * _SQRT3 / self.max_steps

    @cached_property
    def dt_max(self) -> float:
        return 2.0 * _SQRT3 * (2 ** (self.cascades - 1)) / self.grid_size

    @cached_property
    def ladder(self):
        """(tau, dt) numpy arrays: the uniform / gamma step ladder."""
        taus, dts = [], []
        t = 0.0
        span = 2.0 * _SQRT3 * max(self.bound, 1.0)
        if self.gamma_span > 0.0:
            span = min(span, self.gamma_span)
        for _ in range(self.max_steps):
            dt = float(np.clip(t * self.dt_gamma, self.dt_min, self.dt_max))
            taus.append(t)
            dts.append(dt)
            t += dt
            if t > span:
                break
        return np.asarray(taus, np.float32), np.asarray(dts, np.float32)

    @cached_property
    def coarse_gamma_ladder(self):
        """Phase-A ladder for dt_gamma > 0: (taus (T,), dtcs (T,)) numpy."""
        hc = self.grid_size // self.coarse_factor
        cap = 0.95 * 2.0 * min(2.0 ** (self.cascades - 1), self.bound) / hc
        span = 2.0 * _SQRT3 * max(self.bound, 1.0)
        if self.gamma_span > 0.0:
            span = min(span, self.gamma_span)
        taus, dtcs = [], []
        t = 0.0
        for _ in range(self.max_steps):
            dtf = float(np.clip(t * self.dt_gamma, self.dt_min, self.dt_max))
            dtc = min(self.coarse_step_mult * dtf, max(cap, dtf))
            taus.append(t)
            dtcs.append(dtc)
            t += dtc
            if t > span:
                break
        return np.asarray(taus, np.float32), np.asarray(dtcs, np.float32)


def _mul_u32(a, p: int):
    """(a * p) mod 2^32 for int64 a in [0, 2^32) without int64 overflow."""
    lo = (a & 0xFFFF) * p
    hi = ((a >> 16) * p) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _ray_hash_u(rays_d):
    """Deterministic per-ray uniform in [0, 1) from the direction bits
    (MarchConfig.stride_phase "ray_hash"), the reference's uint32 hash in
    int64 arithmetic cut to 32 bits."""
    bits = rays_d.float().contiguous().view(torch.int32).long() & _U32
    h = _mul_u32(bits[:, 0], _HASH_PRIMES[0])
    h = h ^ _mul_u32(bits[:, 1], _HASH_PRIMES[1])
    h = h ^ _mul_u32(bits[:, 2], _HASH_PRIMES[2])
    h = h ^ (h >> 16)
    h = _mul_u32(h, 2654435761)
    h = h ^ (h >> 13)
    return (h >> 8).float() * 2.0**-24


def _mip_from_dt_static(dt, grid_size: int) -> np.ndarray:
    return np.maximum(
        np.ceil(np.log2(np.maximum(np.asarray(dt) * grid_size * 0.5, 1e-9))), 0
    ).astype(np.int64)


def mip_level(pos, dt, cfg: MarchConfig):
    """Cascade selection max(mip_from_pos, mip_from_dt), clamped; int64."""
    mx = pos.abs().amax(dim=-1)
    c_pos = torch.zeros(mx.shape, dtype=torch.int64, device=pos.device)
    for i in range(cfg.cascades - 1):
        c_pos = c_pos + (mx > float(2**i)).long()
    if isinstance(dt, (float, int, np.ndarray)):
        # a cached device constant: a fresh host-to-device copy would wait
        # for the card's queue in every march
        c_dt = device_const(_mip_from_dt_static(dt, cfg.grid_size).tolist(),
                            pos.device).long()
    else:
        c_dt = torch.ceil(torch.log2(
            torch.clamp(dt * cfg.grid_size * 0.5, min=1e-9))).clamp(min=0).long()
    return torch.clamp(torch.maximum(c_pos, c_dt), max=cfg.cascades - 1)


def beam_contract_violation(rays_d, cfg: MarchConfig, n_check: int = 4096) -> float:
    """In-beam spread over the full march span, in coarse-cell units (> 1
    means the beam-shared phase A may drop segments). rays_d: numpy or a
    tensor on any device; evaluated on the host in float64."""
    b = cfg.beam
    if b <= 1:
        return 0.0
    if isinstance(rays_d, torch.Tensor):
        rays_d = rays_d.detach().cpu().numpy()
    d = np.asarray(rays_d[: (min(n_check, rays_d.shape[0]) // b) * b], np.float64)
    if d.shape[0] < b:
        return 0.0
    m = d.reshape(-1, b, 3)
    m = m / np.linalg.norm(m, axis=-1, keepdims=True)
    mean = m.sum(axis=1)
    mean /= np.maximum(np.linalg.norm(mean, axis=-1, keepdims=True), 1e-12)
    cos = np.clip((m * mean[:, None, :]).sum(-1), -1.0, 1.0)
    sin_max = float(np.sqrt(np.maximum(1.0 - cos * cos, 0.0)).max())
    z_max = 2.0 * math.sqrt(3.0) * max(cfg.bound, 1.0)
    cell = 2.0 * min(1.0, cfg.bound) / (cfg.grid_size // cfg.coarse_factor)
    return sin_max * z_max / cell


def _inv_dir(rays_d):
    return 1.0 / torch.where(rays_d.abs() < 1e-9, torch.full_like(rays_d, 1e-9), rays_d)


def crop_near_far(near, far, rays_o, rays_d, crop_aabb):
    """Narrow [near, far] to a crop AABB (6,) tensor [xmin, ymin, zmin, xmax,
    ymax, zmax]; a ray that misses it gets far == near (reference
    marching.py:352-363)."""
    inv_d = _inv_dir(rays_d)
    c0 = (crop_aabb[:3] - rays_o) * inv_d
    c1 = (crop_aabb[3:] - rays_o) * inv_d
    near = torch.maximum(near, torch.minimum(c0, c1).amax(dim=-1))
    far = torch.maximum(torch.minimum(far, torch.maximum(c0, c1).amin(dim=-1)), near)
    return near, far


def near_far_aabb(rays_o, rays_d, bound: float, min_near: float, crop_aabb=None):
    """Slab-test near/far against the bound cube, intersected with the crop
    AABB when one is given."""
    inv_d = _inv_dir(rays_d)
    t0 = (-bound - rays_o) * inv_d
    t1 = (bound - rays_o) * inv_d
    near = torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=min_near)
    far = torch.maximum(torch.maximum(t0, t1).amin(dim=-1), near)
    if crop_aabb is not None:
        near, far = crop_near_far(near, far, rays_o, rays_d, crop_aabb)
    return near, far


def _compact_idx(occ, k: int, spread: bool = True, phase=None, phase_u=None):
    """Keep k of each ray's True candidates under a static budget.

    occ: (N, T) bool. Returns (idx (N, k) int64 positions of the kept
    candidates, valid (N, k) bool, stride (N, 1) int64 dt scale). With more
    than k candidates every stride-th is kept, stride = ceil(count / k),
    starting at the stride phase: phase_u (N,) uniform in [0, 1) gives
    floor(u * stride), phase (N, 1) raw draws give phase % stride, else 0."""
    n, t = occ.shape
    cs = torch.cumsum(occ.long(), dim=1)
    stride = torch.ones((n, 1), dtype=torch.int64, device=occ.device)
    if spread:
        cnt = cs[:, -1:]
        stride = torch.clamp((cnt + k - 1) // k, min=1)
        if phase_u is not None:
            start = torch.minimum((phase_u[:, None] * stride.float()).long(), stride - 1)
        elif phase is not None:
            start = phase % stride
        else:
            start = 0
        occ = occ & ((cs - 1) % stride == start)
        cs = torch.cumsum(occ.long(), dim=1)
    targets = torch.arange(1, k + 1, device=occ.device)
    # the j-th kept candidate sits at the count of positions with cs < j+1;
    # cs is non-decreasing, so that count is a left searchsorted
    idx = torch.searchsorted(cs, targets.expand(n, k).contiguous())
    valid = targets[None, :] <= cs[:, -1:]
    return torch.clamp(idx, max=t - 1), valid, stride


def _select_minor(values, sel, width: int):
    """values (N, W), sel (N, k) ints in [0, width) -> (N, k)."""
    return torch.gather(values[:, :width], 1, sel)


def _phase_a_ladder(near, far, cfg: MarchConfig, round_to: int = 1):
    """Phase-A candidate ladder: (z_a (N, T_A), dt_a, t_a); dt_a is a float
    for the fixed ladder, an (N, 1) tensor for the normalized one."""
    span = 2.0 * _SQRT3 * max(cfg.bound, 1.0)
    base = cfg.dt_min * cfg.coarse_step_mult
    if not cfg.coarse_normalized:
        t_a = int(np.ceil(span / base))
        t_a += (-t_a) % round_to
        taus = torch.arange(t_a, dtype=torch.float32, device=near.device) * base
        return near[:, None] + taus[None, :], base, t_a
    cap = _phase_a_cap(cfg)
    t_a0 = cfg.t_a0_steps or int(np.ceil(span / cap))
    t_a = t_a0 + (-t_a0) % round_to
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal (see hashgrid.hash_grid_encode)
    dt_a = torch.clamp((far - near)[:, None] / device_const(float(t_a0), near.device),
                       base, cap)
    taus = torch.arange(t_a, dtype=torch.float32, device=near.device)
    return near[:, None] + taus[None, :] * dt_a, dt_a, t_a


def _phase_a_cap(cfg: MarchConfig) -> float:
    base = cfg.dt_min * cfg.coarse_step_mult
    hc = cfg.grid_size // cfg.coarse_factor
    safe = 0.98 * 2.0 * min(1.0, cfg.bound) / hc
    return max(min(safe, 2.0 * base), base)


def full_ladder_steps(cfg: MarchConfig) -> int:
    span = 2.0 * _SQRT3 * max(cfg.bound, 1.0)
    return int(np.ceil(span / _phase_a_cap(cfg)))


def phase_a_group_of(cfg: MarchConfig, bc: int = 8) -> int:
    """The anchor-run length march_rays_block uses (bc = coarse block edge)."""
    if cfg.phase_a_group > 0:
        return cfg.phase_a_group
    hc = cfg.grid_size // cfg.coarse_factor
    c0 = min(1.0, cfg.bound)
    base = cfg.dt_min * cfg.coarse_step_mult
    dt_a_max = _phase_a_cap(cfg) if cfg.coarse_normalized else base
    sb_world = bc * 2.0 * c0 / hc
    slack = 1.5 if cfg.coarse_normalized else 1.0
    return max(1, min(int(slack * sb_world / dt_a_max), 32))


def plan_occupied_crop(occ_grids, cfg: MarchConfig, pad_cells: int = 1):
    """(crop_aabb (6,) float32, t_a0_steps) from the occupied-cell AABB of a
    (cascades, H^3) host numpy grid, or (None, 0) when nothing is occupied."""
    h = cfg.grid_size
    occ = np.asarray(occ_grids).reshape(-1, h, h, h) > 0
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for c in range(occ.shape[0]):
        if not occ[c].any():
            continue
        cb = min(2.0**c, cfg.bound)
        cell = 2.0 * cb / h
        idx = np.argwhere(occ[c])
        lo = np.minimum(lo, (idx.min(0) - pad_cells) * cell - cb)
        hi = np.maximum(hi, (idx.max(0) + 1 + pad_cells) * cell - cb)
    if not np.isfinite(lo).all():
        return None, 0
    lo = np.maximum(lo, -cfg.bound)
    hi = np.minimum(hi, cfg.bound)
    diag = float(np.linalg.norm(hi - lo))
    cap = _phase_a_cap(cfg) if cfg.coarse_normalized else (
        cfg.dt_min * cfg.coarse_step_mult)
    auto = int(np.ceil(2.0 * _SQRT3 * max(cfg.bound, 1.0) / cap))
    t_a0 = min(auto, int(np.ceil(diag / cap)) + 2)
    g_a = phase_a_group_of(cfg)
    t_a0 = max(t_a0, 8 * g_a)
    return np.concatenate([lo, hi]).astype(np.float32), t_a0


def plan_occupied_ladder(occ_grids, cfg: MarchConfig, pad_cells: int = 1):
    """Phase-A ladder length bounded by the cube-entry -> occupied-AABB-exit
    span (0 when nothing is occupied), at least 8 anchor runs, at most the
    auto ladder."""
    aabb, _ = plan_occupied_crop(occ_grids, cfg, pad_cells)
    if aabb is None:
        return 0
    span = _occupied_span(aabb, cfg.bound)
    cap = _phase_a_cap(cfg) if cfg.coarse_normalized else (
        cfg.dt_min * cfg.coarse_step_mult)
    auto = int(np.ceil(2.0 * _SQRT3 * max(cfg.bound, 1.0) / cap))
    t_a0 = min(auto, int(np.ceil(span / cap)) + 2)
    g_a = phase_a_group_of(cfg)
    if -(-t_a0 // g_a) < 8:
        t_a0 = 8 * g_a
    return min(t_a0, auto)


def _occupied_span(aabb, bound: float) -> float:
    """Largest distance from a corner of the bound cube to a corner of the
    occupied AABB: a bound on any ray's cube entry -> AABB exit span."""
    lo, hi = aabb[:3], aabb[3:]
    b = bound
    cube = np.array([[x, y, z] for x in (-b, b) for y in (-b, b) for z in (-b, b)])
    ac = np.array([[p[0], q[1], r[2]] for p in (lo, hi) for q in (lo, hi)
                   for r in (lo, hi)])
    return float(np.sqrt(((cube[:, None, :] - ac[None, :, :]) ** 2).sum(-1).max()))


def plan_gamma_span(occ_grids, cfg: MarchConfig, pad_cells: int = 1) -> float:
    """The static gamma ladder's span (MarchConfig.gamma_span) bounded by the
    occupied geometry, plus one dt_min of start jitter and one top-cascade
    coarse step; 0.0 when nothing is occupied (reference marching.py:736-765)."""
    aabb, _ = plan_occupied_crop(occ_grids, cfg, pad_cells)
    full = 2.0 * _SQRT3 * max(cfg.bound, 1.0)
    if aabb is None:
        return 0.0
    span = _occupied_span(aabb, cfg.bound)
    hc = cfg.grid_size // cfg.coarse_factor
    cap = 0.95 * 2.0 * min(2.0 ** (cfg.cascades - 1), cfg.bound) / hc
    return float(min(span + cfg.dt_min + cap, full))


def _with_grid_size(cfg: MarchConfig, grid_size: int) -> MarchConfig:
    return cfg if cfg.grid_size == grid_size else replace(cfg, grid_size=grid_size)


def _block_coords(pos, dt_static, grid_size: int, cfg: MarchConfig, block: int = 4):
    """Per-position (flat block row incl. cascade, local bit) for a block
    table of grid_size^3 cells packed in block^3 tiles."""
    nb = grid_size // block
    shift = block.bit_length() - 1
    mask = block - 1
    cas = mip_level(pos, dt_static, _with_grid_size(cfg, grid_size))
    cas_bound = torch.clamp(torch.exp2(cas.float()), max=cfg.bound)
    u = torch.clamp(pos / cas_bound[..., None] * 0.5 + 0.5, 0.0, 1.0 - 1e-6)
    cell = (u * grid_size).long()
    bx, by, bz = cell[..., 0] >> shift, cell[..., 1] >> shift, cell[..., 2] >> shift
    lx, ly, lz = cell[..., 0] & mask, cell[..., 1] & mask, cell[..., 2] & mask
    flat = cas * (nb**3) + (bx * nb + by) * nb + bz
    local = (lx * block + ly) * block + lz
    return flat, local


def _grouped_block_test(table, flat, local, group: int, anchors=None):
    """Occupancy bits for (N, T) positions from a block table (R, W), reusing
    anchor rows: positions run in groups of `group` along T, only the anchor
    positions' rows are gathered, and each position reads its bit from an
    anchor on its own block row. Positions that match no anchor are
    conservatively occupied (phase B's exact test rejects them)."""
    n, t = flat.shape
    g = group
    w = table.shape[-1]
    if g <= 1:
        rows = table[flat.reshape(-1)].reshape(n, t, w)
        return block_bit_lookup(rows, local)
    f = flat.reshape(n, t // g, g)
    loc = local.reshape(n, t // g, g)
    if anchors is None:
        anchors = [0, g - 1] if g <= 4 else [0, g // 2, g - 1]
    occ = torch.ones(f.shape, dtype=torch.bool, device=flat.device)
    matched = torch.zeros(f.shape, dtype=torch.bool, device=flat.device)
    for a in anchors:
        fa = f[:, :, a]
        rows = table[fa.reshape(-1)].reshape(n, t // g, 1, w)
        hit = f == fa[:, :, None]
        bit = block_bit_lookup(rows, loc)
        occ = torch.where(hit & ~matched, bit, occ)
        matched = matched | hit
    return occ.reshape(n, t)


def dilate_blocks_coarse(blocks_coarse, hc: int, bc: int):
    """1-cell 3D or-pool dilation of a block-packed coarse table (cascades,
    (hc/bc)^3, bc^3/32) -> same shape: the table the beam-shared phase A
    tests, built once per occupancy version."""
    casc = blocks_coarse.shape[0]
    g = unpack_blocks(blocks_coarse, hc).reshape(casc, 1, hc, hc, hc)
    # a 3x3x3 max pool (padding with -inf) is the separable 1-cell or-pool
    g = torch.nn.functional.max_pool3d(g.float(), 3, stride=1, padding=1) > 0
    return pack_blocks(g.reshape(casc, -1), hc, block=bc)


def _check_block_options(cfg: MarchConfig, z_window, stop_after, phase_a):
    if cfg.a0_segments > 0 and cfg.coarse_normalized:
        raise unported("a0_segments (phase-A0 prefilter)", "A6")
    if cfg.proxy_terminate:
        raise unported("proxy_terminate", "A6")
    if cfg.first_k:
        raise unported("first_k compaction", "A6")
    if cfg.coarse_first_k:
        raise unported("coarse_first_k compaction", "A6")
    if z_window is not None:
        raise unported("z_window", "A6")
    if stop_after or phase_a is not None:
        raise unported("phase_a / stop_after (frame-level phase-A split)", "A6")


def march_rays_block(rays_o, rays_d, blocks, blocks_coarse, cfg: MarchConfig,
                     key=None, density_coarse_min=None, crop_aabb=None,
                     z_window=None, stop_after: str = "",
                     blocks_coarse_dilated=None, phase_a=None):
    """Two-phase march against block-packed occupancy rows.

    blocks: (cascades, (H/4)^3, 2) int64 words; blocks_coarse: (cascades,
    (H/cf/bc)^3, bc^3/32) int64 words; key: a MarchKey or None; crop_aabb: a
    (6,) tensor or None. Returns {"z", "dt", "valid", "near", "far"} with
    (N, K) samples.

    dt_gamma > 0: phase A walks MarchConfig.coarse_gamma_ladder, a static
    ladder whose step grows with the distance from the cube entry, and
    phase B subdivides each kept segment by its own step, so the fine test's
    cascade follows that step (reference marching.py:1063-1082, 1164-1199,
    1359-1364)."""
    _check_block_options(cfg, z_window, stop_after, phase_a)
    gamma = cfg.dt_gamma > 0.0
    n = rays_o.shape[0]
    h = cfg.grid_size
    hc = h // cfg.coarse_factor
    bc = block_size_of(blocks_coarse)
    dt = cfg.dt_min
    mult = cfg.coarse_step_mult
    base = dt * mult
    c0 = min(1.0, cfg.bound)
    # the largest phase-A step any ray takes sizes the anchor runs and the
    # fine runs
    if gamma:
        taus_np, dtcs_np = cfg.coarse_gamma_ladder
        dt_a_max = float(dtcs_np.max())
    else:
        dt_a_max = _phase_a_cap(cfg) if cfg.coarse_normalized else base

    # run lengths: a phase-A run spans about one coarse block (1.5x looser on
    # normalized ladders), split into >= 8 runs (the ladder-shape rule)
    sb_world = bc * 2.0 * c0 / hc
    fb_world = 8.0 * c0 / h
    slack = 1.5 if cfg.coarse_normalized else 1.0
    g_a = max(1, min(int(slack * sb_world / dt_a_max), 32))
    if cfg.phase_a_group > 0:
        g_a = cfg.phase_a_group
    elif gamma:
        g_a = max(1, min(g_a, -(-len(taus_np) // 8)))
    elif cfg.coarse_normalized:
        span = 2.0 * _SQRT3 * max(cfg.bound, 1.0)
        t_a0_est = cfg.t_a0_steps or int(np.ceil(span / dt_a_max))
        g_a = max(1, min(g_a, -(-t_a0_est // 8)))
    g_b = 1
    for d in (2, 4, 8):
        if mult % d == 0 and (d - 1) * (dt_a_max / mult) < fb_world:
            g_b = d

    near, far = near_far_aabb(rays_o, rays_d, cfg.bound, cfg.min_near, crop_aabb)
    if key is not None:
        near = near + key.u * dt
    k_a = cfg.coarse_segments
    tbl_coarse = blocks_coarse.reshape(-1, blocks_coarse.shape[-1])

    # beam sharing: phase A runs once per beam of mB consecutive rays against
    # the 1-cell-dilated coarse table; the kept segments go to every member
    mB = cfg.beam if (cfg.beam > 1 and n % cfg.beam == 0) else 1
    oA, dA, nearA, farA = rays_o, rays_d, near, far
    if mB > 1:
        nA = n // mB
        oA = rays_o.reshape(nA, mB, 3)[:, 0]
        dm = rays_d.reshape(nA, mB, 3).sum(dim=1)
        dA = dm / torch.clamp(torch.sqrt((dm * dm).sum(-1, keepdim=True)), min=1e-12)
        nearA = near.reshape(nA, mB).amin(dim=1)
        farA = far.reshape(nA, mB).amax(dim=1)
        if blocks_coarse_dilated is None:
            blocks_coarse_dilated = dilate_blocks_coarse(blocks_coarse, hc, bc)
        tbl_coarse = blocks_coarse_dilated.reshape(-1, blocks_coarse.shape[-1])

    # ---- phase A: coarse segments
    anchors_a = [0, g_a - 1] if (cfg.coarse_anchors == 2 and g_a > 1) else None
    if gamma:
        # the static ladder, padded to whole anchor runs with far-masked tail
        # steps at its last step; its steps are small device rows that the
        # kept indices select from (the reference's unrolled compare-and-
        # select gives the same values)
        pad = (-len(taus_np)) % g_a
        if pad:
            taus_np = np.concatenate(
                [taus_np, taus_np[-1] + dtcs_np[-1] * np.arange(1, pad + 1, dtype=np.float32)])
            dtcs_np = np.concatenate([dtcs_np, np.full(pad, dtcs_np[-1], np.float32)])
        taus = device_const(taus_np.tolist(), rays_o.device)
        z_a = nearA[:, None] + taus[None, :]
        dt_a = dtcs_np
    else:
        z_a, dt_a, _ = _phase_a_ladder(nearA, farA, cfg, round_to=g_a)
    pos_a = oA[:, None, :] + dA[:, None, :] * z_a[..., None]
    flat_a, local_a = _block_coords(pos_a, dt_a, hc, cfg, block=bc)
    occ_a = _grouped_block_test(tbl_coarse, flat_a, local_a, g_a, anchors=anchors_a)
    # a segment is kept if EITHER endpoint lands in an occupied coarse cell
    occ_next = torch.cat([occ_a[:, 1:], torch.zeros_like(occ_a[:, :1])], dim=1)
    occ_a = (occ_a | occ_next) & (z_a < farA[:, None])
    idx_a, valid_a, stride_a = _compact_idx(occ_a, k_a)
    if gamma:
        dtcs = device_const(dtcs_np.tolist(), rays_o.device)
        za_buf = torch.where(valid_a, nearA[:, None] + taus[idx_a], 0.0)
        dta_buf = torch.where(valid_a, dtcs[idx_a] * stride_a.float(), 0.0)
    else:
        za_buf = torch.where(valid_a, nearA[:, None] + idx_a * dt_a, 0.0)
        dta_buf = torch.where(valid_a, dt_a * stride_a.float(), 0.0)
    if mB > 1:
        za_buf = za_buf.repeat_interleave(mB, dim=0)
        dta_buf = dta_buf.repeat_interleave(mB, dim=0)
        valid_a = valid_a.repeat_interleave(mB, dim=0)

    # ---- phase B: fine subdivision of each kept segment
    sub = dta_buf[:, :, None] / device_const(float(mult), rays_o.device)
    offs = torch.arange(mult, dtype=torch.float32, device=rays_o.device)
    z_b = (za_buf[:, :, None] + offs[None, None, :] * sub).reshape(n, -1)
    pos_b = rays_o[:, None, :] + rays_d[:, None, :] * z_b[..., None]
    # under dt_gamma the fine test's cascade follows each segment's own step
    dt_b = sub.expand(n, k_a, mult).reshape(n, -1) if gamma else dt
    flat_b, local_b = _block_coords(pos_b, dt_b, h, cfg)
    occ_b = _grouped_block_test(blocks.reshape(-1, 2), flat_b, local_b, g_b,
                                anchors=[0, g_b - 1] if g_b > 1 else None)
    valid_ab = valid_a[:, :, None].expand(n, k_a, mult).reshape(n, -1)
    occ_b = occ_b & valid_ab & (z_b < far[:, None])
    if mB > 1:
        # a beam segment can start before this member's own AABB entry
        occ_b = occ_b & (z_b >= near[:, None])
    phase = phase_u = None
    if key is not None:
        if cfg.stride_phase == "ray_hash":
            phase_u = _ray_hash_u(rays_d)
        else:
            phase = key.phase
    idx_b, valid, stride_b = _compact_idx(occ_b, cfg.samples_per_ray,
                                          phase=phase, phase_u=phase_u)
    seg = idx_b // mult
    off = (idx_b % mult).float()
    za_sel = _select_minor(za_buf, seg, k_a)
    sub_sel = _select_minor(sub[:, :, 0], seg, k_a)
    z_buf = torch.where(valid, za_sel + off * sub_sel, 0.0)
    dt_buf = torch.where(valid, sub_sel * stride_b.float(), 0.0)
    return {"z": z_buf, "dt": dt_buf, "valid": valid, "near": near, "far": far}


def march(rays_o, rays_d, occupancy, cfg: MarchConfig, key=None, crop_aabb=None,
          z_window=None, stop_after: str = "", phase_a=None):
    """Dispatch to the block marcher; occupancy is a dict with "blocks" and
    "blocks_coarse" (and optionally "blocks_coarse_dilated")."""
    if not (isinstance(occupancy, dict) and occupancy.get("blocks") is not None
            and occupancy.get("blocks_coarse") is not None):
        raise unported("marching without block occupancy tables "
                       "(byte-bitfield marchers)", "A6")
    return march_rays_block(
        rays_o, rays_d, occupancy["blocks"], occupancy["blocks_coarse"], cfg,
        key, density_coarse_min=occupancy.get("density_coarse_min"),
        crop_aabb=crop_aabb, z_window=z_window, stop_after=stop_after,
        blocks_coarse_dilated=occupancy.get("blocks_coarse_dilated"),
        phase_a=phase_a)
