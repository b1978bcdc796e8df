"""Occupancy-grid state layout (the eval half).

Counterpart of nerfnav_tpu/models/occupancy.py: the config and the state
dict the marcher reads. uint32 block words are carried in int64 tensors
(ops/morton.py). The grid maintenance (`update_extra_state`,
`mark_untrained_grid`) arrives with training (ROADMAP A5).
"""

from dataclasses import dataclass
from functools import cached_property
import math

import torch

from nerfnav_tpu_torch.device import resolve_device, unported


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
    grid admits them) the block tables the marcher reads."""
    if cfg.occ_debounce:
        raise unported("occ_debounce (activation debounce plane)", "A5")
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
    if _blocks_supported(cfg):
        bc = 8 if hc % 8 == 0 else 4
        state["blocks"] = torch.zeros(
            (c, (cfg.grid_size // 4) ** 3, 2), dtype=torch.int64, device=dev)
        state["blocks_coarse"] = torch.zeros(
            (c, (hc // bc) ** 3, bc**3 // 32), dtype=torch.int64, device=dev)
    return state
