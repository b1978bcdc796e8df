"""Occupancy-grid ray marching: every marcher of the reference.

Counterpart of nerfnav_tpu/ops/marching.py. `march` dispatches as the
reference does: the block-packed two-phase marcher `march_rays_block` when
both block tables exist, else the byte-bitfield two-phase marcher
`march_rays_two_phase` when a coarse bitfield exists, else the single-phase
`march_rays`; with `proxy_terminate` the byte marchers' samples are then
masked behind the proxy transmittance of the min-pooled coarse density (the
EMA grid where that is missing). `march.calls` counts the marcher each call
took.

The block marcher walks phase A (a per-ray ladder of coarse segments; the
uniform normalized or fixed ladder, the static gamma ladder under dt_gamma,
optionally behind the phase-A0 block-span prefilter, beam-shared against a
dilated coarse table) and keeps K_A occupied segments, optionally ends them
at the proxy transmittance; phase B subdivides them against the fine table
and keeps K samples (spread by a stride, or the first-K hybrid). A depth
window narrows [near, far]; `stop_after` returns after phase A or after
phase B's occupancy test, and `phase_a` takes a frame-wide phase A in
(Trainer's eval_frame_phase_a). Outputs (z, dt, valid), each (N, K), match
the reference exactly: valid bit for bit, z/dt to float32 rounding.
`march_segments` gives each ray's occupied depth extent and
`autotune_march_shape` times phase-A shapes on the live device.

JAX draws a march's randomness from its key; here it is a `MarchKey` of
tensors (`draw_march_key` draws one from a torch.Generator), so a test can
inject the JAX draws. Every divisor that feeds a floor or an index is a
device tensor: CUDA divides by a Python scalar as a multiply by its
reciprocal, which can put a point in the next cell. Its CUDA kernel is
ROADMAP B2.
"""

from dataclasses import dataclass, replace
from functools import cached_property
import math
from typing import NamedTuple

import numpy as np
import torch

from nerfnav_tpu_torch.device import device_const
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


def _cell_index(pos, dt, cfg: MarchConfig):
    """(cascade, row-major cell index) of each position, int64; the cascade
    is a plain 0 on a single-cascade grid."""
    h = cfg.grid_size
    if cfg.cascades == 1:
        cas = 0
        u = pos / device_const(min(1.0, cfg.bound), pos.device)
    else:
        cas = mip_level(pos, dt, cfg)
        cas_bound = torch.clamp(torch.exp2(cas.float()), max=cfg.bound)
        u = pos / cas_bound[..., None]
    cell = (torch.clamp(u * 0.5 + 0.5, 0.0, 1.0 - 1e-6) * h).long()
    return cas, (cell[..., 0] * h + cell[..., 1]) * h + cell[..., 2]


def occupancy_lookup(bitfield, pos, dt, cfg: MarchConfig):
    """Occupancy bits of positions (..., 3) from a (cascades, H^3 / 8) uint8
    bitfield (row-major cells, little-endian bits); dt is the step that
    picks the cascade (a number or numpy row for a static ladder, else a
    tensor broadcastable to pos[..., 0]). Returns bool (...)."""
    cas, idx = _cell_index(pos, dt, cfg)
    return ((bitfield[cas, idx >> 3].long() >> (idx & 7)) & 1).bool()


def density_lookup(density_grid, pos, dt, cfg: MarchConfig):
    """The stored density (cascades, H^3) float32 at each position's cell."""
    cas, idx = _cell_index(pos, dt, cfg)
    return density_grid[cas, idx]


def proxy_terminate_valid(m, rays_o, rays_d, density_grid, cfg: MarchConfig,
                          grid_size: int | None = None):
    """The march's valid mask (N, K) with every sample past the point where
    a proxy transmittance, composited from the stored density at the kept
    samples, falls under cfg.proxy_thresh masked off (reference
    marching.py:314-349). grid_size: the table's own side when it is not
    cfg.grid_size (the min-pooled coarse table)."""
    cfg_l = cfg if grid_size is None else _with_grid_size(cfg, grid_size)
    pos = rays_o[:, None, :] + rays_d[:, None, :] * m["z"][..., None]
    pos = torch.clamp(pos, -cfg.bound, cfg.bound)
    sig = density_lookup(density_grid, pos, m["dt"], cfg_l)
    sig = torch.where(m["valid"], torch.clamp(sig, min=0.0), 0.0)
    return m["valid"] & (_excl_trans(1.0 - torch.exp(-m["dt"] * sig)) > cfg.proxy_thresh)


def _excl_trans(alphas):
    """Transmittance before each sample: shifted cumprod of (1 - alpha)."""
    t = torch.cumprod(1.0 - alphas + 1e-15, dim=-1)
    return torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], dim=-1)


def apply_z_window(near, far, z_window):
    """Narrow [near, far] to a depth window (z_lo, z_hi) of numbers or (N,)
    tensors; a ray the window excludes gets far == near."""
    if z_window is None:
        return near, far
    z_lo, z_hi = (device_const(z, near.device) if isinstance(z, (int, float)) else z
                  for z in z_window)
    near = torch.maximum(near, z_lo)
    return near, torch.maximum(torch.minimum(far, z_hi), near)


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


def _rows(v, n: int, t: int, like):
    """A per-candidate step as an (N, T) view: v is a number, a numpy row
    (T,) or a tensor broadcastable to (N, T)."""
    if isinstance(v, (int, float)):
        return torch.full((n, t), float(v), device=like.device)
    if isinstance(v, np.ndarray):
        v = device_const(v.tolist(), like.device)
    return v.expand(n, t)


def _compact_first_k(occ, z, dtv, k: int, spread: bool = True, phase=None,
                     first_frac: float | None = None, phase_u=None):
    """Keep k of each ray's True candidates (see _compact_idx; first_frac
    selects the first-K hybrid) and gather their z and dt (dt times the
    stride). occ, z (N, T); dtv per _rows. Returns (z, dt, valid), each
    (N, k); a lattice shorter than k is padded with empty candidates."""
    n, t = occ.shape
    dtv = _rows(dtv, n, t, z)
    if t < k:
        pad = k - t
        occ = torch.nn.functional.pad(occ, (0, pad))
        z = torch.nn.functional.pad(z, (0, pad))
        dtv = torch.nn.functional.pad(dtv, (0, pad))
    if first_frac is not None:
        idx, valid, stride = _compact_idx_hybrid(occ, k, first_frac, phase=phase,
                                                 phase_u=phase_u)
    else:
        idx, valid, stride = _compact_idx(occ, k, spread, phase=phase, phase_u=phase_u)
    z_buf = torch.where(valid, torch.gather(z, 1, idx), 0.0)
    dt_buf = torch.where(valid, torch.gather(dtv, 1, idx) * stride.float(), 0.0)
    return z_buf, dt_buf, valid


def _compact_idx_hybrid(occ, k: int, frac: float, phase=None, phase_u=None):
    """The first-K hybrid (MarchConfig.first_k): the first round(frac * k)
    occupied candidates at full resolution, the rest of the budget spread
    by a stride over the candidates past them, its phase aligned to the end
    of the span. Returns (idx (N, k), valid (N, k), stride (N, k))."""
    n, _ = occ.shape
    k_front = max(1, min(k, int(round(k * frac))))
    k_tail = k - k_front
    idx_f, valid_f, _ = _compact_idx(occ, k_front, spread=False)
    ones_f = torch.ones((n, k_front), dtype=torch.int64, device=occ.device)
    if k_tail == 0:
        return idx_f, valid_f, ones_f
    occ_tail = occ & (torch.cumsum(occ.long(), dim=1) > k_front)
    idx_t, valid_t, stride_t = _compact_idx(occ_tail, k_tail, spread=True, phase=phase,
                                            align_end=True, phase_u=phase_u)
    return (torch.cat([idx_f, idx_t], dim=1), torch.cat([valid_f, valid_t], dim=1),
            torch.cat([ones_f, stride_t.expand(n, k_tail)], dim=1))


def _compact_idx(occ, k: int, spread: bool = True, phase=None, phase_u=None,
                 align_end: bool = False):
    """Keep k of each ray's True candidates under a static budget.

    occ: (N, T) bool. Returns (idx (N, k) int64 positions of the kept
    candidates, valid (N, k) bool, stride (N, 1) int64 dt scale). With more
    than k candidates every stride-th is kept, stride = ceil(count / k),
    starting at the stride phase: phase_u (N,) uniform in [0, 1) gives
    floor(u * stride), phase (N, 1) raw draws give phase % stride, else
    align_end keeps each ray's last candidate, else the phase is 0."""
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
        elif align_end:
            start = (torch.clamp(cnt, min=1) - 1) % stride
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


def autotune_march_shape(occupancy, cfg: MarchConfig, rays_o, rays_d, chunk: int = 4096,
                         iters: int = 3, candidates=None, verbose: bool = False):
    """Time the march of the first `chunk` rays (spatially coherent order
    preferred) at each phase-A shape (g_a, t_a0) and return the fastest:
    (best_cfg, [(g_a, t_a0, ms), ...]), ms the median of `iters` timed
    marches after one warm-up (reference marching.py:768-843). On a CUDA
    device CUDA events time the march, on the CPU the host clock.
    candidates defaults to the ladders of 8, 9 and 10 anchor runs that cover
    the occupancy-planned span (the auto ladder when nothing is occupied)
    and the heuristic shape. occupancy must hold the block tables."""
    import time

    if not (isinstance(occupancy, dict) and occupancy.get("blocks") is not None):
        raise ValueError("autotune_march_shape needs block occupancy tables")
    ro, rd = rays_o[:chunk], rays_d[:chunk]
    if candidates is None:
        cap = _phase_a_cap(cfg) if cfg.coarse_normalized else cfg.dt_min * cfg.coarse_step_mult
        auto = int(np.ceil(2.0 * _SQRT3 * max(cfg.bound, 1.0) / cap))
        occ_host = np.unpackbits(occupancy["bitfield"].cpu().numpy(), axis=-1,
                                 bitorder="little")
        t_base = plan_occupied_ladder(occ_host, cfg) or auto
        candidates = [(max(2, -(-t_base // runs)), runs * max(2, -(-t_base // runs)))
                      for runs in (8, 9, 10)]
        g_inc = max(1, min(phase_a_group_of(cfg), -(-t_base // 8)))
        candidates.append((g_inc, -(-t_base // g_inc) * g_inc))
        candidates = list(dict.fromkeys(candidates))
    cuda = ro.device.type == "cuda"
    results = []
    for g_a, t_a0 in candidates:
        cfg_c = replace(cfg, phase_a_group=g_a, t_a0_steps=t_a0)
        march(ro, rd, occupancy, cfg_c)
        ts = []
        for _ in range(iters):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                march(ro, rd, occupancy, cfg_c)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                march(ro, rd, occupancy, cfg_c)
                ts.append((time.perf_counter() - t0) * 1e3)
        ms = sorted(ts)[len(ts) // 2]
        results.append((g_a, t_a0, ms))
        if verbose:
            print(f"autotune g_a={g_a} t_a0={t_a0}: {ms:.2f} ms")
    g_b, t_b, _ = min(results, key=lambda r: r[2])
    return replace(cfg, phase_a_group=g_b, t_a0_steps=t_b), results


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


def _min_pool_coarse(dmin, hc: int):
    """3^3 min-pool of a (cascades, hc^3) density table, out-of-grid
    neighbours ignored: the proxy table of a beam-shared march."""
    casc = dmin.shape[0]
    g = dmin.reshape(casc, 1, hc, hc, hc)
    return -torch.nn.functional.max_pool3d(-g, 3, stride=1, padding=1).reshape(dmin.shape)


def _terminate_segments(za_buf, dta_buf, valid_a, o, d, table, dt_a_max, cfg, hc):
    """Segment-level proxy termination (reference marching.py:1290-1333): the
    kept segments' valid mask with every segment past the point where the
    transmittance through the min-pooled coarse density at the segments'
    midpoints falls under cfg.proxy_thresh masked off."""
    pos = o[:, None, :] + d[:, None, :] * (za_buf + 0.5 * dta_buf)[..., None]
    sig = density_lookup(table, pos, dt_a_max, _with_grid_size(cfg, hc))
    sig = torch.where(valid_a, torch.clamp(sig, min=0.0), 0.0)
    return valid_a & (_excl_trans(1.0 - torch.exp(-dta_buf * sig)) > cfg.proxy_thresh)


def _phase_a0(oA, dA, nearA, farA, tbl_coarse, cfg, hc, bc, sb_world, dt_a_max):
    """The phase-A0 prefilter (MarchConfig.a0_segments, reference
    marching.py:1200-1263): a ladder at one coarse-block edge against "any
    cell of the block occupied" keeps a0_segments block spans; phase A's
    cell-exact test runs only inside them, each span subdivided into mult0
    segments. A span the A0 compaction widened by its stride is occupied
    throughout (its subdivision would step over cells). Returns phase A's
    (za_buf, dta_buf, valid_a), each (N_A, K_A)."""
    n_a = oA.shape[0]
    dev = oA.device
    any_tbl = (tbl_coarse != 0).any(dim=-1)
    dt_a0 = 0.98 * sb_world
    t_a0 = int(np.ceil(2.0 * _SQRT3 * max(cfg.bound, 1.0) / dt_a0))
    z_a0 = nearA[:, None] + torch.arange(t_a0, dtype=torch.float32, device=dev) * dt_a0
    pos_a0 = oA[:, None, :] + dA[:, None, :] * z_a0[..., None]
    flat_a0, _ = _block_coords(pos_a0, dt_a0, hc, cfg, block=bc)
    occ_a0 = _kept_segments(any_tbl[flat_a0], z_a0, farA)
    k_a0 = cfg.a0_segments
    idx_a0, valid_a0, stride_a0 = _compact_idx(occ_a0, k_a0)
    z0_buf = torch.where(valid_a0, nearA[:, None] + idx_a0 * dt_a0, 0.0)
    dt0_buf = torch.where(valid_a0, dt_a0 * stride_a0.float(), 0.0)

    # mult0 + 1 test points per span (the last closes the endpoint pair at
    # the span's end); a span is one coarse block, so its end anchors cover
    # its rows
    mult0 = int(np.ceil(dt_a0 / dt_a_max - 1e-6))
    sub0 = dt0_buf[:, :, None] / device_const(float(mult0), dev)
    jj = torch.arange(mult0 + 1, dtype=torch.float32, device=dev)
    z_t = z0_buf[:, :, None] + jj * sub0
    pos_t = oA[:, None, None, :] + dA[:, None, None, :] * z_t[..., None]
    dt_t = sub0.expand(z_t.shape).reshape(n_a, -1)
    flat_t, local_t = _block_coords(pos_t.reshape(n_a, -1, 3), dt_t, hc, cfg, block=bc)
    occ_t = _grouped_block_test(tbl_coarse, flat_t, local_t, mult0 + 1,
                                anchors=[0, mult0]).reshape(n_a, k_a0, mult0 + 1)
    occ_a = (occ_t[:, :, :-1] | occ_t[:, :, 1:]) | (stride_a0[:, :, None] > 1)
    occ_a = occ_a & valid_a0[:, :, None] & (z_t[:, :, :-1] < farA[:, None, None])
    idx_a, valid_a, stride_a = _compact_idx(occ_a.reshape(n_a, k_a0 * mult0),
                                            cfg.coarse_segments)
    seg0 = idx_a // mult0
    off0 = (idx_a % mult0).float()
    z0_sel = _select_minor(z0_buf, seg0, k_a0)
    sub0_sel = _select_minor(sub0[:, :, 0], seg0, k_a0)
    za_buf = torch.where(valid_a, z0_sel + off0 * sub0_sel, 0.0)
    dta_buf = torch.where(valid_a, sub0_sel * stride_a.float(), 0.0)
    return za_buf, dta_buf, valid_a


def march_rays_block(rays_o, rays_d, blocks, blocks_coarse, cfg: MarchConfig,
                     key=None, density_coarse_min=None, crop_aabb=None,
                     z_window=None, stop_after: str = "",
                     blocks_coarse_dilated=None, phase_a=None):
    """Two-phase march against block-packed occupancy rows.

    blocks: (cascades, (H/4)^3, 2) int64 words; blocks_coarse: (cascades,
    (H/cf/bc)^3, bc^3/32) int64 words; key: a MarchKey or None; crop_aabb: a
    (6,) tensor or None; z_window: (z_lo, z_hi) numbers or (N,) tensors.
    Returns {"z", "dt", "valid", "near", "far"} with (N, K) samples.

    dt_gamma > 0: phase A walks MarchConfig.coarse_gamma_ladder, a static
    ladder whose step grows with the distance from the cube entry, and
    phase B subdivides each kept segment by its own step, so the fine test's
    cascade follows that step (reference marching.py:1063-1082, 1164-1199,
    1359-1364).

    stop_after="phase_a" returns phase A's kept segments (N, K_A), after
    the beam broadcast; "phase_b_occ" returns phase B's candidates (N, K_A
    * mult) with their occupancy as "valid" and zero dt. phase_a: a dict of
    those segments ("z", "dt", "valid") from a frame-wide stop_after march
    of the same rays; phase A is then skipped. It needs dt_gamma == 0, and
    under cfg.beam > 1 an N that divides by the beam (the members' mask
    needs the beam width): the reference skips that mask there instead of
    raising (ROADMAP C)."""
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
    near, far = apply_z_window(near, far, z_window)
    if key is not None:
        near = near + key.u * dt
    k_a = cfg.coarse_segments

    mB = cfg.beam if (cfg.beam > 1 and n % cfg.beam == 0) else 1
    if phase_a is not None:
        if gamma:
            raise ValueError("phase_a split is unsupported with dt_gamma > 0")
        if cfg.beam > 1 and mB == 1:
            raise ValueError(
                f"phase_a with beam {cfg.beam} needs N divisible by the beam, got {n}: "
                "the members' z_b >= near mask needs the beam width")
        za_buf, dta_buf, valid_a = phase_a["z"], phase_a["dt"], phase_a["valid"]
    else:
        za_buf, dta_buf, valid_a = _phase_a(
            rays_o, rays_d, near, far, blocks_coarse, blocks_coarse_dilated,
            density_coarse_min, cfg, mB, g_a, hc, bc, sb_world, dt_a_max)
        if stop_after == "phase_a":
            return {"z": za_buf, "dt": dta_buf, "valid": valid_a, "near": near, "far": far}

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
    if stop_after == "phase_b_occ":
        return {"z": z_b, "dt": torch.zeros_like(z_b), "valid": occ_b,
                "near": near, "far": far}
    phase, phase_u = _stride_phase(key, rays_d, cfg)
    if cfg.first_k:
        idx_b, valid, stride_b = _compact_idx_hybrid(occ_b, cfg.samples_per_ray,
                                                     cfg.first_k_frac, phase=phase,
                                                     phase_u=phase_u)
    else:
        idx_b, valid, stride_b = _compact_idx(occ_b, cfg.samples_per_ray,
                                              phase=phase, phase_u=phase_u)
    seg = idx_b // mult
    off = (idx_b % mult).float()
    za_sel = _select_minor(za_buf, seg, k_a)
    sub_sel = _select_minor(sub[:, :, 0], seg, k_a)
    z_buf = torch.where(valid, za_sel + off * sub_sel, 0.0)
    dt_buf = torch.where(valid, sub_sel * stride_b.float(), 0.0)
    return {"z": z_buf, "dt": dt_buf, "valid": valid, "near": near, "far": far}


def _stride_phase(key, rays_d, cfg: MarchConfig):
    """(phase, phase_u) for _compact_idx: a keyed march's raw draws, or its
    per-ray hash under stride_phase "ray_hash"; (None, None) unkeyed."""
    if key is None:
        return None, None
    if cfg.stride_phase == "ray_hash":
        return None, _ray_hash_u(rays_d)
    return key.phase, None


def _phase_a(rays_o, rays_d, near, far, blocks_coarse, blocks_coarse_dilated,
             density_coarse_min, cfg: MarchConfig, mB, g_a, hc, bc, sb_world, dt_a_max):
    """The block marcher's phase A: (za_buf, dta_buf, valid_a), each (N,
    K_A), the kept coarse segments broadcast to the members of each beam."""
    n = rays_o.shape[0]
    k_a = cfg.coarse_segments
    tbl_coarse = blocks_coarse.reshape(-1, blocks_coarse.shape[-1])
    # beam sharing: phase A runs once per beam of mB consecutive rays against
    # the 1-cell-dilated coarse table; the kept segments go to every member
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

    anchors_a = [0, g_a - 1] if (cfg.coarse_anchors == 2 and g_a > 1) else None
    if cfg.dt_gamma > 0.0:
        # the static ladder, padded to whole anchor runs with far-masked tail
        # steps at its last step; its steps are small device rows that the
        # kept indices select from (the reference's unrolled compare-and-
        # select gives the same values)
        taus_np, dtcs_np = cfg.coarse_gamma_ladder
        pad = (-len(taus_np)) % g_a
        if pad:
            taus_np = np.concatenate(
                [taus_np, taus_np[-1] + dtcs_np[-1] * np.arange(1, pad + 1, dtype=np.float32)])
            dtcs_np = np.concatenate([dtcs_np, np.full(pad, dtcs_np[-1], np.float32)])
        taus = device_const(taus_np.tolist(), rays_o.device)
        z_a = nearA[:, None] + taus[None, :]
        occ_a = _coarse_test(oA, dA, z_a, farA, dtcs_np, tbl_coarse, g_a, anchors_a,
                             cfg, hc, bc)
        idx_a, valid_a, stride_a = _compact_idx(occ_a, k_a)
        dtcs = device_const(dtcs_np.tolist(), rays_o.device)
        za_buf = torch.where(valid_a, nearA[:, None] + taus[idx_a], 0.0)
        dta_buf = torch.where(valid_a, dtcs[idx_a] * stride_a.float(), 0.0)
    elif cfg.a0_segments > 0 and cfg.coarse_normalized:
        za_buf, dta_buf, valid_a = _phase_a0(oA, dA, nearA, farA, tbl_coarse, cfg, hc,
                                             bc, sb_world, dt_a_max)
    else:
        z_a, dt_a, _ = _phase_a_ladder(nearA, farA, cfg, round_to=g_a)
        occ_a = _coarse_test(oA, dA, z_a, farA, dt_a, tbl_coarse, g_a, anchors_a, cfg,
                             hc, bc)
        if cfg.coarse_first_k:
            idx_a, valid_a, stride_a = _compact_idx_hybrid(occ_a, k_a, cfg.first_k_frac)
        else:
            idx_a, valid_a, stride_a = _compact_idx(occ_a, k_a)
        za_buf = torch.where(valid_a, nearA[:, None] + idx_a * dt_a, 0.0)
        dta_buf = torch.where(valid_a, dt_a * stride_a.float(), 0.0)

    if cfg.proxy_terminate and density_coarse_min is not None:
        # the beam ray's transmittance must hold for every member: under a
        # beam the table is min-pooled over the dilation's neighbourhood
        table = _min_pool_coarse(density_coarse_min, hc) if mB > 1 else density_coarse_min
        valid_a = _terminate_segments(za_buf, dta_buf, valid_a, oA, dA, table, dt_a_max,
                                      cfg, hc)
    if mB > 1:
        za_buf = za_buf.repeat_interleave(mB, dim=0)
        dta_buf = dta_buf.repeat_interleave(mB, dim=0)
        valid_a = valid_a.repeat_interleave(mB, dim=0)
    return za_buf, dta_buf, valid_a


def _coarse_test(o, d, z_a, far, dt_a, tbl_coarse, g_a, anchors, cfg, hc, bc):
    """Phase A's segments to keep on the ladder z_a (N, T), tested against
    the block-packed coarse table."""
    pos_a = o[:, None, :] + d[:, None, :] * z_a[..., None]
    flat_a, local_a = _block_coords(pos_a, dt_a, hc, cfg, block=bc)
    return _kept_segments(_grouped_block_test(tbl_coarse, flat_a, local_a, g_a,
                                              anchors=anchors), z_a, far)


def _kept_segments(occ, z, far):
    """Segments [z_i, z_i+1) of a ladder (N, T) to keep: either endpoint
    tests occupied, and the segment starts before far."""
    occ_next = torch.cat([occ[:, 1:], torch.zeros_like(occ[:, :1])], dim=1)
    return (occ | occ_next) & (z < far[:, None])


def march_rays(rays_o, rays_d, bitfield, cfg: MarchConfig, key=None, crop_aabb=None,
               z_window=None):
    """Single-phase march: the whole step ladder (MarchConfig.ladder) tested
    against the byte bitfield, the first K occupied candidates kept (spread
    by a stride, or the first-K hybrid). Returns {"z", "dt", "valid", "near",
    "far"} with (N, K) samples (reference marching.py:1405-1442)."""
    taus_np, dts_np = cfg.ladder
    near, far = near_far_aabb(rays_o, rays_d, cfg.bound, cfg.min_near, crop_aabb)
    near, far = apply_z_window(near, far, z_window)
    if key is not None:
        near = near + key.u * cfg.dt_min
    z = near[:, None] + device_const(taus_np.tolist(), rays_o.device)[None, :]
    pos = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    occ = occupancy_lookup(bitfield, pos, dts_np, cfg) & (z < far[:, None])
    phase, phase_u = _stride_phase(key, rays_d, cfg)
    z_buf, dt_buf, valid = _compact_first_k(
        occ, z, dts_np, cfg.samples_per_ray, phase=phase,
        first_frac=cfg.first_k_frac if cfg.first_k else None, phase_u=phase_u)
    return {"z": z_buf, "dt": dt_buf, "valid": valid, "near": near, "far": far}


def march_rays_two_phase(rays_o, rays_d, bitfield, bitfield_coarse, cfg: MarchConfig,
                         key=None, crop_aabb=None, z_window=None):
    """Two-phase march against byte bitfields: phase A walks the coarse
    ladder (normalized, fixed, or the static gamma ladder under dt_gamma)
    against the coarse bitfield and keeps K_A segments; phase B subdivides
    them against the fine bitfield and keeps K samples (reference
    marching.py:846-929)."""
    n = rays_o.shape[0]
    dev = rays_o.device
    dt = cfg.dt_min
    gamma = cfg.dt_gamma > 0.0
    near, far = near_far_aabb(rays_o, rays_d, cfg.bound, cfg.min_near, crop_aabb)
    near, far = apply_z_window(near, far, z_window)
    if key is not None:
        near = near + key.u * dt
    cfg_coarse = _with_grid_size(cfg, cfg.grid_size // cfg.coarse_factor)
    if gamma:
        taus_np, dt_a = cfg.coarse_gamma_ladder
        z_a = near[:, None] + device_const(taus_np.tolist(), dev)[None, :]
    else:
        z_a, dt_a, _ = _phase_a_ladder(near, far, cfg)
    pos_a = rays_o[:, None, :] + rays_d[:, None, :] * z_a[..., None]
    occ_a = _kept_segments(occupancy_lookup(bitfield_coarse, pos_a, dt_a, cfg_coarse),
                           z_a, far)
    za_buf, dta_buf, valid_a = _compact_first_k(occ_a, z_a, dt_a, cfg.coarse_segments)

    # phase B over each kept segment's (possibly stride-scaled) length
    mult = cfg.coarse_step_mult
    k_a = cfg.coarse_segments
    sub = dta_buf[:, :, None] / device_const(float(mult), dev)
    offs = torch.arange(mult, dtype=torch.float32, device=dev)
    z_b = (za_buf[:, :, None] + offs[None, None, :] * sub).reshape(n, -1)
    dt_fine = sub.expand(n, k_a, mult).reshape(n, -1)
    pos_b = rays_o[:, None, :] + rays_d[:, None, :] * z_b[..., None]
    occ_b = occupancy_lookup(bitfield, pos_b, dt_fine if gamma else dt, cfg)
    valid_ab = valid_a[:, :, None].expand(n, k_a, mult).reshape(n, -1)
    occ_b = occ_b & valid_ab & (z_b < far[:, None])
    phase, phase_u = _stride_phase(key, rays_d, cfg)
    z_buf, dt_buf, valid = _compact_first_k(
        occ_b, z_b, dt_fine, cfg.samples_per_ray, phase=phase,
        first_frac=cfg.first_k_frac if cfg.first_k else None, phase_u=phase_u)
    return {"z": z_buf, "dt": dt_buf, "valid": valid, "near": near, "far": far}


def march_segments(rays_o, rays_d, occupancy, cfg: MarchConfig, crop_aabb=None):
    """Each ray's occupied depth extent from phase A alone, on the whole
    uncompacted coarse ladder: {"z_first", "z_last", "hit"}, each (N,).
    Needs occupancy["bitfield_coarse"] (reference marching.py:1445-1483)."""
    coarse = occupancy.get("bitfield_coarse") if isinstance(occupancy, dict) else None
    if coarse is None:
        raise ValueError(
            "march_segments needs occupancy['bitfield_coarse']: the fine bitfield "
            "alone cannot be probed safely at coarse ladder steps")
    near, far = near_far_aabb(rays_o, rays_d, cfg.bound, cfg.min_near, crop_aabb)
    z_a, dt_a, _ = _phase_a_ladder(near, far, cfg)
    pos_a = rays_o[:, None, :] + rays_d[:, None, :] * z_a[..., None]
    occ_a = _kept_segments(occupancy_lookup(
        coarse, pos_a, dt_a, _with_grid_size(cfg, cfg.grid_size // cfg.coarse_factor)),
        z_a, far)
    dt_b = _rows(dt_a, *z_a.shape, z_a)
    inf = torch.full_like(z_a, math.inf)
    return {"z_first": torch.where(occ_a, z_a, inf).amin(dim=1),
            "z_last": torch.where(occ_a, z_a + dt_b, -inf).amax(dim=1),
            "hit": occ_a.any(dim=1)}


def march(rays_o, rays_d, occupancy, cfg: MarchConfig, key=None, crop_aabb=None,
          z_window=None, stop_after: str = "", phase_a=None):
    """Dispatch as the reference does (marching.py:1486-1537): the block
    marcher when occupancy holds both block tables, else the byte two-phase
    marcher when it holds "bitfield_coarse", else the single-phase one.
    occupancy: an occupancy-state dict or a bare (cascades, H^3 / 8)
    bitfield. Under cfg.proxy_terminate the byte marchers' samples are then
    masked by proxy_terminate_valid on "density_coarse_min" (conservative),
    else on "density_grid"; the block marcher ends its segments itself.
    Adds one to march.calls[name] of the marcher it took."""
    if isinstance(occupancy, dict):
        bitfield = occupancy["bitfield"]
        get = occupancy.get
    else:
        bitfield, get = occupancy, {}.get
    blocks, blocks_coarse = get("blocks"), get("blocks_coarse")
    if blocks is not None and blocks_coarse is not None:
        march.calls["block"] += 1
        return march_rays_block(
            rays_o, rays_d, blocks, blocks_coarse, cfg, key,
            density_coarse_min=get("density_coarse_min"), crop_aabb=crop_aabb,
            z_window=z_window, stop_after=stop_after,
            blocks_coarse_dilated=get("blocks_coarse_dilated"), phase_a=phase_a)
    if stop_after or phase_a is not None:
        raise ValueError("stop_after / phase_a need the block marcher's tables")
    coarse = get("bitfield_coarse")
    if coarse is not None:
        march.calls["two_phase"] += 1
        m = march_rays_two_phase(rays_o, rays_d, bitfield, coarse, cfg, key,
                                 crop_aabb=crop_aabb, z_window=z_window)
    else:
        march.calls["single"] += 1
        m = march_rays(rays_o, rays_d, bitfield, cfg, key, crop_aabb=crop_aabb,
                       z_window=z_window)
    if cfg.proxy_terminate:
        if get("density_coarse_min") is not None:
            m = {**m, "valid": proxy_terminate_valid(
                m, rays_o, rays_d, get("density_coarse_min"), cfg,
                grid_size=cfg.grid_size // cfg.coarse_factor)}
        elif get("density_grid") is not None:
            m = {**m, "valid": proxy_terminate_valid(m, rays_o, rays_d,
                                                     get("density_grid"), cfg)}
    return m


march.calls = {"block": 0, "two_phase": 0, "single": 0}
