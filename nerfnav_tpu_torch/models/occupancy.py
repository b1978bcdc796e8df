"""Occupancy-grid state and its maintenance.

Counterpart of nerfnav_tpu/models/occupancy.py: the config, the state dict
the marcher reads (uint32 block words carried in int64 tensors,
ops/morton.py), the density sweeps of `update_extra_state` (full for the
first n_full_updates, then partial), `_finish_update` with its options,
`mark_untrained_grid` and `reset_extra_state`. With `occ_debounce` the
state carries a "pending" plane (bool (cascades, H^3)) and a cell turns on
only after two consecutive observed sweeps above the carve bar. The sweeps'
random draws (jitter, uniform and occupied cells) are explicit tensors
(`UpdateDraws`, made by `draw_update`), so a test can inject the JAX
package's draws. Under a device mesh each rank queries its block of a
sweep's cells (with its slice of the shared draws) and the densities are
gathered; the EMA-max merge is elementwise and runs replicated.
"""

from dataclasses import dataclass
from functools import cached_property
import math
from typing import NamedTuple, Optional

import torch

from nerfnav_tpu_torch.device import resolve_device
from nerfnav_tpu_torch.models import network as net
from nerfnav_tpu_torch.ops.morton import pack_blocks, packbits, unpackbits
from nerfnav_tpu_torch.parallel import gather_rays, mesh_size, shard_rays


@dataclass(frozen=True)
class OccupancyConfig:
    bound: float = 1.0
    grid_size: int = 128
    density_thresh: float = 10.0
    decay: float = 0.95
    n_full_updates: int = 16
    update_chunk: int = 2 ** 17
    min_near: float = 0.2
    coarse_factor: int = 4
    ema_sampled_only: bool = False
    occ_hysteresis: float = 0.0
    density_write_clamp: float = 0.0
    ema_toward_query: bool = False
    occ_debounce: bool = False

    @cached_property
    def cascades(self) -> int:
        return 1 + math.ceil(math.log2(max(self.bound, 1.0)))

    @cached_property
    def n_cells(self) -> int:
        return self.grid_size ** 3


def _blocks_supported(cfg: OccupancyConfig) -> bool:
    hc = cfg.grid_size // cfg.coarse_factor
    return cfg.grid_size % 4 == 0 and hc % 4 == 0


def init_occupancy_state(cfg: OccupancyConfig, device="cuda"):
    """Empty occupancy state: density grids, byte bitfields and (where the
    grid admits them) the block tables the marcher reads; with occ_debounce
    the "pending" plane of cells seen above the bar once."""
    dev = resolve_device(device)
    hc = cfg.grid_size // cfg.coarse_factor
    c = cfg.cascades
    state = {
        "density_grid": torch.zeros((c, cfg.n_cells), dtype=torch.float32, device=dev),
        "bitfield": torch.zeros((c, cfg.n_cells // 8), dtype=torch.uint8, device=dev),
        "bitfield_coarse": torch.zeros((c, hc**3 // 8), dtype=torch.uint8, device=dev),
        "mean_density": torch.zeros((), dtype=torch.float32, device=dev),
        "iter_density": torch.zeros((), dtype=torch.int64, device=dev),
        "density_coarse_min": torch.zeros((c, hc**3), dtype=torch.float32, device=dev),
    }
    if cfg.occ_debounce:
        state["pending"] = torch.zeros((c, cfg.n_cells), dtype=torch.bool, device=dev)
    if _blocks_supported(cfg):
        bc = 8 if hc % 8 == 0 else 4
        state["blocks"] = torch.zeros(
            (c, (cfg.grid_size // 4) ** 3, 2), dtype=torch.int64, device=dev)
        state["blocks_coarse"] = torch.zeros(
            (c, (hc // bc) ** 3, bc**3 // 32), dtype=torch.int64, device=dev)
    return state


class UpdateDraws(NamedTuple):
    """The draws of one cascade's density sweep: jitter (n, 3) uniform in
    [0, 1) for the n queried cells; a partial sweep also has rand_cells
    (n/2,) uniform cell ids and u (n/2,) uniform in [0, 1) for the
    inverse-CDF draw of occupied cells."""
    jitter: torch.Tensor
    rand_cells: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None


def _partial(state, cfg: OccupancyConfig) -> bool:
    return int(state["iter_density"]) >= cfg.n_full_updates


def draw_update(generator, state, cfg: OccupancyConfig):
    """One UpdateDraws per cascade for the sweep update_extra_state will run
    on `state`, from a torch.Generator on the state's device."""
    dev = state["density_grid"].device
    if not _partial(state, cfg):
        return [UpdateDraws(jitter=torch.rand((cfg.n_cells, 3), generator=generator,
                                              device=dev))
                for _ in range(cfg.cascades)]
    n = cfg.n_cells // 4
    return [UpdateDraws(
        rand_cells=torch.randint(0, cfg.n_cells, (n,), generator=generator, device=dev),
        u=torch.rand((n,), generator=generator, device=dev),
        jitter=torch.rand((2 * n, 3), generator=generator, device=dev))
        for _ in range(cfg.cascades)]


def _cell_centers(cfg: OccupancyConfig, cell_idx):
    """Flat row-major cell indices -> centers in [-1, 1]^3 (unit cube)."""
    h = cfg.grid_size
    coords = torch.stack([cell_idx // (h * h), (cell_idx // h) % h, cell_idx % h], -1)
    return (coords.float() + 0.5) / h * 2.0 - 1.0


def _query_cells(params, net_cfg, cfg: OccupancyConfig, cell_idx, cas: int, jitter,
                 mesh=None):
    """Density at a jittered point inside each cell of cascade `cas`, in
    chunks of cfg.update_chunk points; with a mesh, this rank's block of the
    cells, the blocks then gathered (reference occupancy.py:157-185)."""
    if mesh is not None:
        n = cell_idx.shape[0]
        pad = (-n) % mesh_size(mesh)
        if pad:  # equal blocks: the padding queries cell 0 and is dropped
            cell_idx = torch.cat([cell_idx, cell_idx.new_zeros(pad)])
            jitter = torch.cat([jitter, jitter.new_zeros((pad, 3))])
        cell_idx, jitter = shard_rays((cell_idx, jitter), mesh)
        return gather_rays(_query_cells(params, net_cfg, cfg, cell_idx, cas, jitter),
                           mesh)[:n]
    centers = _cell_centers(cfg, cell_idx)
    cas_bound = torch.full((), min(2.0**cas, cfg.bound), device=centers.device)
    half_cell = cas_bound / cfg.grid_size
    pts = centers * (cas_bound - half_cell) + (jitter * 2.0 - 1.0) * half_cell
    c = cfg.update_chunk
    return torch.cat([net.density(params, pts[i : i + c], net_cfg)["sigma"]
                      for i in range(0, pts.shape[0], c)])


def _update_full(state, cfg: OccupancyConfig, params, net_cfg, draws, thresh_cap=None,
                 mesh=None):
    grid = state["density_grid"]
    tmp = torch.full_like(grid, -1.0)
    cells = torch.arange(cfg.n_cells, device=grid.device)
    for cas in range(cfg.cascades):
        sig = _query_cells(params, net_cfg, cfg, cells, cas, draws[cas].jitter, mesh)
        tmp[cas] = sig * net_cfg.density_scale
    return _finish_update(state, cfg, grid, tmp, thresh_cap)


def _update_partial(state, cfg: OccupancyConfig, params, net_cfg, draws,
                    thresh_cap=None, mesh=None):
    """n_cells/4 uniform cells plus n_cells/4 cells drawn from the occupied
    ones (inverse CDF over the occupancy mask; uniform when none is)."""
    grid = state["density_grid"]
    tmp = torch.full_like(grid, -1.0)
    for cas in range(cfg.cascades):
        d = draws[cas]
        cdf = torch.cumsum((grid[cas] > 0).float(), 0)
        total = cdf[-1]
        u = d.u * torch.clamp(total, min=1.0)
        occ_cells = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, cfg.n_cells - 1)
        occ_cells = torch.where(total > 0, occ_cells, d.rand_cells)
        cells = torch.cat([d.rand_cells, occ_cells])
        sig = _query_cells(params, net_cfg, cfg, cells, cas, d.jitter, mesh)
        tmp[cas].scatter_reduce_(0, cells, sig * net_cfg.density_scale, "amax")
    return _finish_update(state, cfg, grid, tmp, thresh_cap)


def _finish_update(state, cfg: OccupancyConfig, grid, tmp, thresh_cap=None):
    """EMA of the sweep into the grid, the carve bar, the repacked bitfields
    and block tables and the min-pooled coarse density.

    With density_write_clamp and ema_toward_query both on, mean_density
    follows the max-EMA rule while the stored grid follows the mean-EMA
    rule: the reference is inconsistent with itself there (ROADMAP C), and
    the port copies it.

    With occ_debounce an inactive cell turns on only if this sweep and the
    previous observed one both queried it above the bar; "pending" holds the
    cells seen above it once, and an unsampled cell keeps its mark."""
    valid = (grid >= 0) & (tmp >= 0) if cfg.ema_sampled_only else grid >= 0
    tmp_stored = tmp
    if cfg.density_write_clamp > 0.0:
        tmp_stored = torch.clamp(tmp, max=cfg.density_write_clamp * cfg.density_thresh)
    if cfg.ema_toward_query:
        cand = cfg.decay * grid + (1.0 - cfg.decay) * tmp_stored
        new_grid = torch.where(valid & (tmp >= 0), cand,
                               torch.where(valid, grid * cfg.decay, grid))
    else:
        new_grid = torch.where(valid, torch.maximum(grid * cfg.decay, tmp_stored), grid)
    raw = new_grid
    if cfg.density_write_clamp > 0.0:
        # the bar statistic follows the raw (unclamped) sweep values
        raw = torch.where(valid, torch.maximum(grid * cfg.decay, tmp), grid)
    mean_density = torch.clamp(raw, min=0.0).mean()
    thresh = torch.clamp(mean_density, max=cfg.density_thresh)
    if thresh_cap is not None:
        thresh = torch.minimum(thresh, torch.as_tensor(thresh_cap, device=grid.device))
    occ = new_grid > thresh
    new_pending = None
    if cfg.occ_debounce:
        prev = unpackbits(state["bitfield"]).reshape(occ.shape)
        sampled = tmp >= 0
        tmp_high = sampled & (tmp > thresh)
        pending = state["pending"]
        occ = occ & (prev | (tmp_high & pending))
        new_pending = torch.where(sampled, tmp_high & ~occ, pending & ~occ)
    if cfg.occ_hysteresis > 0.0:
        prev = unpackbits(state["bitfield"]).reshape(occ.shape)
        occ = occ | (prev & (new_grid > cfg.occ_hysteresis * thresh))
    h, f, c = cfg.grid_size, cfg.coarse_factor, cfg.cascades
    hc = h // f
    occ_coarse = occ.reshape(c, hc, f, hc, f, hc, f).to(torch.uint8).amax(
        dim=(2, 4, 6)).reshape(c, hc**3) > 0
    out = {
        "density_grid": new_grid,
        "bitfield": packbits(occ),
        "bitfield_coarse": packbits(occ_coarse),
        "mean_density": mean_density,
        "iter_density": state["iter_density"] + 1,
    }
    if new_pending is not None:
        out["pending"] = new_pending
    if _blocks_supported(cfg):
        out["blocks"] = pack_blocks(occ, h)
        out["blocks_coarse"] = pack_blocks(occ_coarse, hc, block=8 if hc % 8 == 0 else 4)
    out["density_coarse_min"] = torch.clamp(new_grid, min=0.0).reshape(
        c, hc, f, hc, f, hc, f).amin(dim=(2, 4, 6)).reshape(c, hc**3)
    return out


@torch.no_grad()
def update_extra_state(state, cfg: OccupancyConfig, params, net_cfg, draws,
                       thresh_cap=None, mesh=None):
    """One density sweep: full for the first cfg.n_full_updates, then
    partial (the reference's renderer.py:446-451 dispatch, a host read of
    the update counter). draws: draw_update's list for this state, the same
    on every rank of a mesh. thresh_cap pins the carve bar
    (TrainerOptions.occ_thresh_freeze_after). mesh: a parallel.make_mesh
    mesh, whose ranks query the cells in blocks."""
    update = _update_partial if _partial(state, cfg) else _update_full
    return update(state, cfg, params, net_cfg, draws, thresh_cap, mesh)


def reset_extra_state(state, cfg: OccupancyConfig):
    """A fresh state on the same device, "pending" cleared too (reference
    renderer.py:113-118)."""
    return init_occupancy_state(cfg, device=state["density_grid"].device)


@torch.no_grad()
def mark_untrained_grid(state, cfg: OccupancyConfig, poses, intrinsics, H_img: int,
                        W_img: int):
    """Pin to -1 every cell no training camera sees (its center outside every
    frustum, with half a pixel of slack), so it never turns on. poses: (P, 4,
    4) camera-to-world; intrinsics (4,), both tensors on the state's device."""
    grid = state["density_grid"].clone()
    fx, fy = intrinsics[0], intrinsics[1]
    rot, t = poses[:, :3, :3], poses[:, :3, 3]
    cells = torch.arange(cfg.n_cells, device=grid.device)
    for cas in range(cfg.cascades):
        cas_bound = min(2.0**cas, cfg.bound)
        centers = _cell_centers(cfg, cells) * (cas_bound - cas_bound / cfg.grid_size)
        counts = []
        for i in range(0, cfg.n_cells, cfg.update_chunk):
            rel = centers[i : i + cfg.update_chunk, None, :] - t[None]   # (n, P, 3)
            # x_cam = R^T (x - t), each coordinate summed in index order
            cam = (rel[..., 0:1] * rot[None, :, 0, :] + rel[..., 1:2] * rot[None, :, 1, :]
                   + rel[..., 2:3] * rot[None, :, 2, :])
            x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
            seen = ((z > cfg.min_near) & (x.abs() * fx < (W_img / 2 + 0.5) * z.abs())
                    & (y.abs() * fy < (H_img / 2 + 0.5) * z.abs()))
            counts.append(seen.sum(dim=-1))
        grid[cas] = torch.where(torch.cat(counts) == 0, -1.0, grid[cas])
    return {**state, "density_grid": grid}
