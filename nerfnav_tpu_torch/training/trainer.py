"""The Trainer's eval-render half: `render_full`.

Counterpart of nerfnav_tpu/training/trainer.py (`TrainerOptions` and the
eval methods of `Trainer`, trainer.py:606-644 and :864-1282). A frame is cut
into 64x64-tile-ordered chunks of `max_ray_batch` rays; each chunk is
marched with the occupancy-planned phase-A ladder and the AUTO beam, and
shaded in early-terminating rounds. The chunk loop runs eagerly, so
`TrainerOptions.eval_scan` and `render_full(frozen=...)`, which shape the
reference's compiled program, have no effect here.

Training (the train step, occupancy maintenance, checkpoint writing,
evaluate/test) arrives with ROADMAP A9.
"""

from dataclasses import dataclass, replace
import logging

import numpy as np
import torch

from nerfnav_tpu_torch.data.rays import rays_from_pixels, tile_order
from nerfnav_tpu_torch.device import resolve_device, unported
from nerfnav_tpu_torch.models.network import NetworkConfig, init_network
from nerfnav_tpu_torch.models.renderer import (
    RenderConfig, make_field, render_rays_grid_rounds,
)
from nerfnav_tpu_torch.ops.marching import (
    beam_contract_violation, dilate_blocks_coarse, phase_a_group_of,
    plan_occupied_ladder,
)
from nerfnav_tpu_torch.ops.morton import block_size_of


@dataclass
class TrainerOptions:
    """Field for field the reference's TrainerOptions (see its comments);
    this slice reads only the eval_* fields, shade_order and seed."""
    name: str = "ngp"
    workspace: str = "workspace"
    lr: float = 1e-2
    iters: int = 30000
    lr_iters: int = 0
    num_rays: int = 4096
    eval_interval: int = 50
    max_keep_ckpt: int = 2
    ema_decay: float = 0.95
    bg_train: str = "random"
    use_checkpoint: str = "latest"
    error_map: bool = False
    update_extra_interval: int = 16
    scan_steps: int = 1
    occ_freeze_after: float = 0.0
    occ_thresh_freeze_after: float = 0.0
    seed: int = 0
    tensorboard: bool = False
    eval_rounds: bool = True
    shade_order: str = "ray"
    eval_scan: bool = True          # no effect: the chunk loop is eager
    eval_frame_phase_a: bool = False
    eval_occ_ladder: bool = True
    eval_coarse_segments: int = 12
    eval_coarse_anchors: int = 2
    eval_first_k: bool = False
    eval_proxy: bool = False
    eval_beam: int = 0
    dt_anneal: tuple = ((0.0, 8), (0.05, 4), (0.1, 2), (0.2, 1))
    point_budget: bool = True
    point_budget_fracs: tuple = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75)
    point_budget_margin: float = 1.15
    stride_phase: str = "random"
    rand_pose: int = -1
    clip_text: str = ""
    rand_pose_radius: float = 1.0
    eval_table_dtype: str = "bfloat16"


class Trainer:
    def __init__(self, cfg: NetworkConfig, rcfg: RenderConfig,
                 opt: TrainerOptions, params=None, occupancy_cfg=None,
                 march_cfg=None, mesh=None, clip_loss_fn=None, occupancy=None,
                 device="cuda"):
        """march_cfg + occupancy_cfg enable the occupancy-grid path; the
        occupancy state itself (the reference keeps it in its TrainState) is
        passed as `occupancy` or set with `set_occupancy`."""
        if march_cfg is not None and occupancy_cfg is None:
            raise ValueError("march_cfg requires occupancy_cfg")
        if mesh is not None:
            raise unported("device meshes (data-parallel rendering)", "A11")
        if opt.rand_pose >= 0 or clip_loss_fn is not None:
            raise unported("rand_pose / CLIP-guided training", "A11")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rcfg = rcfg
        self.opt = opt
        self.occupancy_cfg = occupancy_cfg
        self.march_cfg = march_cfg
        if params is None:
            params = init_network(torch.Generator().manual_seed(opt.seed), cfg,
                                  device=self.device)
        self.params = params
        self.occupancy = None
        self._occ_version = 0
        self._table_cast_cache = None  # (params, cast params)
        self._ladder_plan = None       # (occ_version, t_a0)
        self._tile_layouts = {}        # (H, W, chunk) -> tile-major layout
        self._beam_dilate_cache = None
        self._beam_guard_cache = {}
        if occupancy is not None:
            self.set_occupancy(occupancy)

    def set_occupancy(self, occupancy):
        """Replace the occupancy state; bumps the version the plan caches key on."""
        self.occupancy = occupancy
        self._occ_version += 1

    @staticmethod
    def _apply_ladder_plan(mcfg, plan):
        """An int plan is a t_a0_steps override; 0 = no plan."""
        if not plan or mcfg is None:
            return mcfg
        if isinstance(plan, float):
            return replace(mcfg, gamma_span=plan)
        return replace(mcfg, t_a0_steps=plan)

    def _eval_march_cfg(self):
        """The training MarchConfig with the render-only trims applied."""
        mcfg = self.march_cfg
        if mcfg is None:
            return None
        seg = self.opt.eval_coarse_segments or mcfg.coarse_segments
        anch = self.opt.eval_coarse_anchors or mcfg.coarse_anchors
        fk = self.opt.eval_first_k or mcfg.first_k
        px = self.opt.eval_proxy or mcfg.proxy_terminate
        if (seg, anch, fk, px) == (mcfg.coarse_segments, mcfg.coarse_anchors,
                                   mcfg.first_k, mcfg.proxy_terminate):
            return mcfg
        return replace(mcfg, coarse_segments=seg, coarse_anchors=anch,
                       first_k=fk, proxy_terminate=px)

    def _cast_eval_tables(self, params):
        """Hash tables in opt.eval_table_dtype, cached per params object.

        With the fused MLP backend the MLP weights are also stored in bf16,
        the type the kernel reads, so no call re-casts them."""
        if (self._table_cast_cache is None
                or self._table_cast_cache[0] is not params):
            dtype = getattr(torch, self.opt.eval_table_dtype)
            cast = dict(params)
            cast["encoder"] = [t.to(dtype) for t in params["encoder"]]
            if self.cfg.mlp_backend == "fused":
                for k in ("sigma_net", "color_net"):
                    cast[k] = [w.to(torch.bfloat16) for w in params[k]]
            self._table_cast_cache = (params, cast)
        return self._table_cast_cache[1]

    def _tile_layout(self, H, W, chunk):
        """Cached tile-major layout of one frame shape: padded pixel coords
        (i, j), the inverse permutation and the host perm."""
        key = (H, W, chunk)
        tc = self._tile_layouts.get(key)
        if tc is None:
            perm, inv = tile_order(H, W, 64)
            jj, ii = np.meshgrid(np.arange(H, dtype=np.float32),
                                 np.arange(W, dtype=np.float32), indexing="ij")
            i = ii.reshape(-1)[perm]
            j = jj.reshape(-1)[perm]
            pad = (-H * W) % chunk
            if pad:
                # pad with the last real pixel, so a chunk-boundary beam that
                # mixes real and pad rays stays coherent
                i = np.concatenate([i, np.full(pad, i[-1], np.float32)])
                j = np.concatenate([j, np.full(pad, j[-1], np.float32)])
            tc = {"i": torch.as_tensor(i, device=self.device),
                  "j": torch.as_tensor(j, device=self.device),
                  "inv": torch.as_tensor(inv, device=self.device), "perm": perm}
            self._tile_layouts[key] = tc
        return tc

    def _auto_beam(self, intrinsics) -> int:
        """Largest power-of-two beam (<= 16) whose in-beam spread over the
        march span stays under one cascade-0 coarse cell."""
        mcfg = self.march_cfg
        if mcfg is None:
            return 1
        focal = float(np.minimum(intrinsics[0], intrinsics[1]))
        hc = mcfg.grid_size // mcfg.coarse_factor
        cell = 2.0 * min(1.0, mcfg.bound) / hc
        z_max = 2.0 * np.sqrt(3.0) * max(mcfg.bound, 1.0)
        b = int(focal * cell / z_max) + 1
        for cand in (16, 8, 4, 2):
            if b >= cand:
                return cand
        return 1

    def _beamed_occupancy(self, occupancy):
        """The occupancy dict plus the 1-cell-dilated coarse table the beamed
        phase A tests, built once per occupancy version."""
        if occupancy.get("blocks_coarse") is None:
            return occupancy
        cached = self._beam_dilate_cache
        if cached is None or cached[0] != self._occ_version:
            bcrs = occupancy["blocks_coarse"]
            hc = self.march_cfg.grid_size // self.march_cfg.coarse_factor
            cached = (self._occ_version,
                      dilate_blocks_coarse(bcrs, hc, block_size_of(bcrs)))
            self._beam_dilate_cache = cached
        return {**occupancy, "blocks_coarse_dilated": cached[1]}

    @staticmethod
    def _clamp_beam_to_rows(bm: int, W: int) -> int:
        """A beam must stay within one tile row (64 px, or W % 64 at the
        right edge): step down to a power of two dividing both."""
        edge = W % 64
        while bm > 1 and (64 % bm or (edge % bm if edge else 0)):
            bm //= 2
        return max(bm, 1)

    def _planned_ladder(self, occupancy) -> int:
        """Occupancy-derived phase-A ladder length for eval rendering,
        planned once per occupancy version (0 = the config's auto ladder)."""
        mcfg = self.march_cfg
        if (mcfg is None or not self.opt.eval_occ_ladder
                or not self.opt.eval_rounds or not isinstance(occupancy, dict)):
            return 0
        if mcfg.dt_gamma > 0.0:
            raise unported("dt_gamma > 0 (gamma-span ladder plan)", "A6")
        if not mcfg.coarse_normalized or mcfg.t_a0_steps:
            return 0
        cached = self._ladder_plan
        if cached is not None and cached[0] == self._occ_version:
            return cached[1]
        bits = occupancy["bitfield"].cpu().numpy()
        occ = np.unpackbits(bits, axis=-1, bitorder="little")
        ecfg = self._eval_march_cfg()
        t_a0 = plan_occupied_ladder(occ, ecfg)
        if t_a0:
            g = phase_a_group_of(ecfg)
            t_a0 = -(-t_a0 // g) * g
        self._ladder_plan = (self._occ_version, t_a0)
        return t_a0

    def _chunk_renderer(self, t_a0: int = 0, beam: int = 0):
        """The eval chunk renderer for a planned ladder length (0 = auto) and
        beam width (0 = the march config's own)."""
        cfg = self.cfg
        mcfg = self._apply_ladder_plan(self._eval_march_cfg(), t_a0)
        if beam and beam > 1:
            mcfg = replace(mcfg, beam=beam)
        shade_order = self.opt.shade_order

        def render_chunk(params, occupancy, rays_o, rays_d, bg_color):
            return render_rays_grid_rounds(
                make_field(params, cfg), occupancy, mcfg, rays_o, rays_d,
                bg_color=bg_color, shade_order=shade_order)

        return render_chunk

    def _frame_rays(self, pose, intrinsics, H, W, chunk, pixel_offset):
        """Tile-ordered, chunk-padded rays of one frame: (ro, rd, inv)."""
        tc = self._tile_layout(H, W, chunk)
        offset = torch.as_tensor(
            pixel_offset if pixel_offset is not None else (0.0, 0.0),
            dtype=torch.float32, device=self.device)
        r = rays_from_pixels(
            torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=self.device),
            torch.as_tensor(np.asarray(intrinsics), dtype=torch.float32,
                            device=self.device),
            tc["i"], tc["j"], offset=offset)
        return r["rays_o"], r["rays_d"], tc["inv"]

    def _frame_beam(self, intrinsics, H, W, rd) -> int:
        """The beam width render_full uses for this frame (0 = off): AUTO from
        the focal unless opt.eval_beam fixes it, clamped to tile rows, and
        refused when the spread guard on the first 4096 rays fails."""
        bm = (self.opt.eval_beam if self.opt.eval_beam > 0
              else self._auto_beam(intrinsics))
        bm = self._clamp_beam_to_rows(bm, W)
        if bm <= 1:
            return 0
        gk = (H, W, bm, float(intrinsics[0]), float(intrinsics[1]))
        if gk not in self._beam_guard_cache:
            # the reference measures the first 4096 rays only (ROADMAP C)
            self._beam_guard_cache[gk] = beam_contract_violation(
                rd[:4096], replace(self._eval_march_cfg(), beam=bm))
        if self._beam_guard_cache[gk] > 1.0:
            logging.getLogger("nerfnav").warning(
                "eval beam %d violates the 1-coarse-cell spread contract "
                "(%.2f cells over the march span) on this frame; rendering "
                "unbeamed, see MarchConfig.beam", bm, self._beam_guard_cache[gk])
            return 0
        return bm

    def render_full(self, params, pose, intrinsics, H, W, bg_color=1.0,
                    crop_aabb=None, pixel_offset=None, frozen=False):
        """Render an H x W frame: (image (H, W, 3), depth (H, W)).

        pose: (4, 4) camera-to-world; intrinsics: (fx, fy, cx, cy);
        pixel_offset: optional (dx, dy) subpixel shift. `frozen` has no
        effect in eager PyTorch."""
        if self.march_cfg is None:
            raise unported("the dense render path (no occupancy grid)", "A4")
        if not self.opt.eval_rounds:
            raise unported("the single-shot grid render (eval_rounds=False)", "A7")
        if self.opt.eval_frame_phase_a:
            raise unported("eval_frame_phase_a (frame-level phase A)", "A6")
        if crop_aabb is not None:
            raise unported("crop_aabb", "A6")
        occupancy = self.occupancy
        if not (isinstance(occupancy, dict) and occupancy.get("blocks") is not None
                and occupancy.get("blocks_coarse") is not None):
            raise unported("rendering without block occupancy tables "
                           "(byte-bitfield marchers)", "A6")
        with torch.no_grad():
            if self.opt.eval_table_dtype != "float32":
                params = self._cast_eval_tables(params)
            n = H * W
            chunk = self.rcfg.max_ray_batch
            ro, rd, inv = self._frame_rays(pose, intrinsics, H, W, chunk,
                                           pixel_offset)
            t_a0 = self._planned_ladder(occupancy)
            bm = self._frame_beam(intrinsics, H, W, rd)
            if bm > 1:
                occupancy = self._beamed_occupancy(occupancy)
            render_chunk = self._chunk_renderer(t_a0, bm)
            imgs, depths = [], []
            for i in range(0, ro.shape[0], chunk):
                out = render_chunk(params, occupancy, ro[i : i + chunk],
                                   rd[i : i + chunk], float(bg_color))
                imgs.append(out["image"])
                depths.append(out["depth"])
            image = torch.cat(imgs)[:n][inv]
            depth = torch.cat(depths)[:n][inv]
        return image.reshape(H, W, 3), depth.reshape(H, W)
