"""The Trainer: the train step, its loop and checkpoints, and the eval render.

Counterpart of nerfnav_tpu/training/trainer.py (`TrainerOptions`, `TrainState`
and `Trainer`). Each step samples rays of one image (`get_rays`) and renders
them: with an occupancy grid (`--cuda_ray`, `-O`) by `render_rays_grid` under
a march key (densely, or packed to the point budget picked from the
mean-count EMA), without one by the dense `render_rays` with jittered
samples. It takes the MSE against the image on a random or fixed
background, and applies Adam(0.9, 0.99, eps 1e-15) at lr 0.1^(t/lr_horizon)
(the schedule reads the pre-increment count, as optax does), the EMA of the
params, the error-map EMA and the mean-count EMA. Every 16 steps
`_maybe_update_occupancy` sweeps the density grid.

`render_full` renders a frame in chunks through the rounds renderer on
tile-ordered rays (the grid path; with `eval_frame_phase_a`, one frame-wide
phase A feeds every chunk), the one-shot grid render (`eval_rounds=False`)
or the dense render, on any occupancy the marcher takes (block tables or
byte bitfields); `evaluate` writes the validation images, `test` a camera
path's frames, depth maps and video and `save_mesh` the density's
iso-surface; `train_gui` and `test_gui` are the interactive viewer's hooks
(gui/viewer.py).

The step is two functions, `loss_and_grads` and `apply`, joined by
`train_step`. JAX's PRNG streams do not match torch's, so every random draw
of a step (pixels or error-map bins and jitter, the background, the march
key) and of an occupancy sweep is a tensor argument (`StepDraws`,
`UpdateDraws`), drawn at run time from the torch.Generator the Trainer owns
(seeded from opt.seed); the image index comes from numpy's default_rng as in
the reference. The reference's compiled programs become eager calls: the
step cache, `scan_steps` (steps here run one at a time, which the reference
pins as step-identical), `eval_scan` and `render_full(frozen=...)` have no
effect.

A `MipNerfConfig` in place of the NetworkConfig trains mip-NeRF (Barron et
al. 2021) through the same step and loop: cone rays with radii (`get_rays(...,
cone=True)`), `render_rays_mip`'s two levels from the step's stratified and
resampling draws, the loss 0.1 x the coarse MSE + the fine MSE, Adam(0.9,
0.999, eps 1e-8) at mipnerf's delayed log-linear rate, and no EMA (the EMA
params are the params); `render_full` renders it in ray chunks with the
evenly spaced levels; it takes no occupancy grid, data-parallel mesh,
poseless batches or `save_mesh`.

With `rand_pose` >= 0 the loop takes poseless similarity batches
(`clip_step`): a low-resolution frame from a random orbit pose rendered on
white and scored by `clip_loss_fn` (training/clip_tower.py), every batch
(rand_pose 0) or one per rand_pose supervised batches.

With a device mesh (parallel/sharding.py, one process per device) every
rank draws the global batch and its draws from the same generators, shades
its block of the rays with its own packing into budget / world slots (the
reference's sample_groups = world), and the gradients are averaged over the
mesh; the sample counts that pick the point budget are summed over it, so
every rank takes the same host-side decisions. Occupancy sweeps and
`render_full` split their points and each chunk's rays the same way and
gather the results. Only rank 0 writes checkpoints, images and the log.
"""

from dataclasses import dataclass, field, replace
import logging
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from nerfnav_tpu_torch.data.provider import write_image
from nerfnav_tpu_torch.data.provider import rand_poses
from nerfnav_tpu_torch.data.rays import (
    EMAP_SIDE, RayDraws, cone_rays, draw_rays, get_all_rays, get_padded_rays, get_rays,
    rays_from_pixels, tile_order,
)
from nerfnav_tpu_torch.device import resolve_device
from nerfnav_tpu_torch.models.network import (
    MipNerfConfig, NetworkConfig, init_mipnerf, init_network,
)
from nerfnav_tpu_torch.models.occupancy import (
    draw_update, init_occupancy_state, mark_untrained_grid, update_extra_state,
)
from nerfnav_tpu_torch.models.renderer import (
    RenderConfig, make_field, render_rays, render_rays_grid, render_rays_grid_rounds,
    render_rays_mip,
)
from nerfnav_tpu_torch.ops.marching import (
    MarchKey, beam_contract_violation, dilate_blocks_coarse, draw_march_key, march,
    phase_a_group_of, plan_gamma_span, plan_occupied_ladder,
)
from nerfnav_tpu_torch.ops.morton import block_size_of
from nerfnav_tpu_torch.parallel import (
    all_mean, all_sum, gather_rays, mesh_rank, mesh_size, shard_rays,
)
from nerfnav_tpu_torch.training import checkpoint as ckpt_lib
from nerfnav_tpu_torch.training.metrics import PSNRMeter
from nerfnav_tpu_torch.utils.profiling import span


@dataclass
class TrainerOptions:
    """Field for field the reference's TrainerOptions (see its comments)."""
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
    scan_steps: int = 1             # steps still run one at a time
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

@dataclass
class TrainState:
    """What a train step reads and writes. params are leaf tensors that
    require grad (the optimizer updates them in place); the Adam moments and
    count live in `optimizer`; occupancy is the one home of the occupancy
    grid, which render_full reads too."""
    params: dict
    optimizer: torch.optim.Adam
    ema_params: dict
    global_step: int = 0
    error_maps: Optional[torch.Tensor] = None   # (n_images, 128 * 128)
    occupancy: Optional[dict] = None
    mean_count: Optional[torch.Tensor] = None   # EMA of valid samples per step
    stats: dict = field(default_factory=lambda: {
        "loss": [], "valid_loss": [], "results": [], "best_result": None})


class StepDraws(NamedTuple):
    """The random draws of one train step: the march key on the grid path,
    the sample jitter (and importance-sampling draws) on the dense one. A
    poseless step (clip_step) has no image, pixels or background."""
    idx: int                  # image index
    rays: Optional[RayDraws]
    bg: Optional[torch.Tensor]  # (num_rays, 3) background colors
    march: Optional[MarchKey] = None
    # (num_rays, num_steps) and (num_rays, upsample_steps); mip-NeRF's are
    # both (num_rays, num_samples + 1), the coarse strata and the resample
    jitter: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None


class StepOut(NamedTuple):
    """What a step's loss_and_grads gives apply; under a mesh every field
    covers the global batch (gradients averaged, per-ray values gathered,
    sample counts summed)."""
    loss: torch.Tensor        # 0-d
    per_ray: torch.Tensor     # (num_rays,) MSE per ray
    n_samples: torch.Tensor   # 0-d valid samples before the point budget
    grads: list               # one per param, in _leaves order
    inds: torch.Tensor        # (num_rays,) flat pixel indices


def _leaves(params):
    """The param tensors in the reference's pytree order (sorted keys)."""
    return [t for k in sorted(params) for t in params[k]]


class Trainer:
    def __init__(self, cfg: NetworkConfig, rcfg: RenderConfig,
                 opt: TrainerOptions, params=None, occupancy_cfg=None,
                 march_cfg=None, mesh=None, clip_loss_fn=None, occupancy=None,
                 device="cuda", *, sample_groups: int = 1):
        """march_cfg + occupancy_cfg enable the occupancy-grid path. The
        occupancy state starts as `occupancy` (for instance a loaded
        checkpoint's), else empty; `set_occupancy` replaces it.

        mesh: a parallel.make_mesh mesh of the processes that train together
        (data parallel over rays; `device` is this rank's). sample_groups:
        without a mesh, pack each train step in that many blocks as a mesh of
        that size does (reference trainer.py:493-494), so one process can
        take a mesh's steps; a mesh sets it to its size. clip_loss_fn:
        a differentiable (h, w, 3) image -> 0-d loss on the device, which
        rand_pose >= 0 needs (training/clip_tower.py make_clip_loss_fn)."""
        if march_cfg is not None and occupancy_cfg is None:
            raise ValueError("march_cfg requires occupancy_cfg")
        self.mip = isinstance(cfg, MipNerfConfig)
        if self.mip and (march_cfg is not None or mesh is not None or sample_groups != 1
                         or opt.rand_pose >= 0):
            raise ValueError("mip-NeRF trains on the dense path of one process, with "
                             "supervised batches")
        self.mesh = mesh
        self._rank = 0
        if mesh is not None:
            if sample_groups != 1:
                raise ValueError("a mesh packs in groups of its size: pass a mesh "
                                 "or sample_groups, not both")
            sample_groups, self._rank = mesh_size(mesh), mesh_rank(mesh)
            if opt.num_rays % sample_groups:
                raise ValueError(
                    f"num_rays ({opt.num_rays}) must divide evenly across "
                    f"{sample_groups} devices")
        self._groups = sample_groups
        self.clip_loss_fn = clip_loss_fn
        if opt.rand_pose >= 0 and clip_loss_fn is None:
            raise RuntimeError(
                "rand_pose mode needs a differentiable clip_loss_fn "
                "(training/clip_tower.py make_clip_loss_fn with user-supplied "
                "pretrained weights); pass one, or a stub scorer")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rcfg = rcfg
        self.opt = opt
        self.occupancy_cfg = occupancy_cfg
        self.march_cfg = march_cfg
        self.workspace = opt.workspace
        self.ckpt_dir = os.path.join(opt.workspace, "checkpoints")
        self.log_path = os.path.join(opt.workspace, f"log_{opt.name}.txt")
        self.lr_horizon = opt.lr_iters or max(1, opt.iters)
        self.epoch = 0
        # the init weights come from a CPU generator (same tables on every
        # device); the step and sweep draws from one on the Trainer's device
        self._init_gen = torch.Generator().manual_seed(opt.seed)
        self.gen = torch.Generator(device=self.device).manual_seed(opt.seed)
        if params is None:
            params = self._init_params()
        self._occ_version = 0
        self._params_version = 0
        self._mean_count_host = 0.0
        self._pinned_thresh = None
        self._train_mcfgs = {}         # dt_mult -> training MarchConfig
        self._fresh = True             # no train() call since init / reset
        self._table_cast_cache = None  # (params, version, cast params)
        self._ladder_plan = None       # (occ_version, t_a0)
        self._tile_layouts = {}        # (H, W, chunk) -> tile-major layout
        self._beam_dilate_cache = None
        self._beam_guard_cache = {}
        self._gui_arrays = None        # (train_ds, its device arrays) of train_gui
        self.state = self._init_state(1, params, occupancy)
        self.writer = None  # reference trainer.py:302-309
        if opt.tensorboard and self._rank == 0:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(os.path.join(self.workspace, "run", opt.name))
            except ImportError:
                self.log("tensorboardX unavailable; scalars not written")

    # ------------------------------------------------------------- state
    def _init_params(self):
        init = init_mipnerf if self.mip else init_network
        return init(self._init_gen, self.cfg, device=self.device)

    def _init_state(self, n_images: int, params, occupancy=None) -> TrainState:
        """A fresh TrainState on `params` (copied to f32 leaves that require
        grad): zero Adam moments, EMA = params, error maps at 0.1, the given
        or an empty occupancy state, mean count 0."""
        params = {k: [t.detach().to(self.device, torch.float32).clone().requires_grad_()
                      for t in v] for k, v in params.items()}
        betas, eps = (self.cfg.adam_betas, self.cfg.adam_eps) if self.mip else ((0.9, 0.99),
                                                                                1e-15)
        optimizer = torch.optim.Adam(_leaves(params), lr=self.opt.lr, betas=betas, eps=eps)
        if occupancy is None and self.occupancy_cfg is not None:
            occupancy = init_occupancy_state(self.occupancy_cfg, device=self.device)
        self._occ_version += 1
        self._params_version += 1
        return TrainState(
            params=params, optimizer=optimizer,
            ema_params=params if self.mip else {k: [t.detach().clone() for t in v]
                                                for k, v in params.items()},
            error_maps=(torch.full((n_images, EMAP_SIDE**2), 0.1, device=self.device)
                        if self.opt.error_map else None),
            occupancy=occupancy,
            mean_count=(torch.zeros((), device=self.device)
                        if self.march_cfg is not None else None))

    @property
    def params(self):
        return self.state.params

    @property
    def occupancy(self):
        return self.state.occupancy

    @property
    def global_step(self) -> int:
        return self.state.global_step

    @property
    def stats(self) -> dict:
        return self.state.stats

    def set_occupancy(self, occupancy):
        """Replace the occupancy state; bumps the version the plan caches key on."""
        self.state.occupancy = occupancy
        self._occ_version += 1

    def reset_model(self):
        """Fresh weights (the next draw of the init generator), optimizer,
        EMA, error maps and occupancy: the GUI's reset button."""
        n_images = (self.state.error_maps.shape[0]
                    if self.state.error_maps is not None else 1)
        self.state = self._init_state(n_images, self._init_params())
        self.epoch = 0
        self._mean_count_host = 0.0
        self._table_cast_cache = None

    def log(self, *msg):
        if self._rank:
            return
        text = " ".join(str(m) for m in msg)
        print(f"[{self.opt.name}] {text}")
        os.makedirs(self.workspace, exist_ok=True)
        with open(self.log_path, "a") as f:
            f.write(text + "\n")

    # ---------------------------------------------------------- schedule
    def _lr(self, count: int) -> float:
        """LambdaLR's 0.1^(t / lr_horizon) at the pre-increment Adam count;
        mip-NeRF's schedule at step count + 1 (mipnerf's first step is 1)."""
        if self.mip:
            return self.cfg.lr(count + 1)
        return self.opt.lr * (0.1 ** (count / self.lr_horizon))

    def _steps_to_phase_boundary(self) -> int:
        """Steps until the next occupancy-update or dt-anneal boundary."""
        interval = self.opt.update_extra_interval
        dist = interval - (self.global_step % interval)
        for threshold, _ in self.opt.dt_anneal:
            if threshold <= 1.0:
                threshold = threshold * self.opt.iters
            if self.global_step < threshold:
                dist = min(dist, int(threshold) - self.global_step)
        return max(dist, 1)

    def _current_budget(self):
        """The packed shade's sample budget: the smallest bucket covering
        margin x the host mirror of the mean-count EMA, a multiple of
        sample_groups; None shades the full (N, K) lattice."""
        if (self.march_cfg is None
                or not self.opt.point_budget or self._mean_count_host <= 0):
            return None
        nk = self.opt.num_rays * self.march_cfg.samples_per_ray
        groups = self._groups
        required = self.opt.point_budget_margin * self._mean_count_host
        for frac in sorted(self.opt.point_budget_fracs):
            if frac * nk >= required and frac < 1.0:
                b = int(frac * nk)
                return max(b - b % groups, groups)
        return None

    def _dt_mult(self) -> int:
        """The marching dt multiplier of the anneal schedule at this step."""
        if self.march_cfg is None:
            return 1
        mult = 1
        for threshold, m in self.opt.dt_anneal:
            if threshold <= 1.0:
                threshold = threshold * self.opt.iters
            if self.global_step >= threshold:
                mult = m
        return mult

    def _train_march_cfg(self):
        """The training march: the fixed phase-A ladder, no proxy
        termination, the configured stride phase, max_steps // dt_mult."""
        dt_mult = self._dt_mult()
        if dt_mult not in self._train_mcfgs:
            mcfg = self.march_cfg
            self._train_mcfgs[dt_mult] = replace(
                mcfg, coarse_normalized=False, proxy_terminate=False,
                stride_phase=self.opt.stride_phase,
                max_steps=max(mcfg.max_steps // dt_mult, 8) if dt_mult > 1
                else mcfg.max_steps)
        return self._train_mcfgs[dt_mult]

    # -------------------------------------------------------- train step
    def _device_arrays(self, ds):
        """ds.as_arrays() (numpy poses, images, intrinsics) on the device."""
        return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=self.device)
                for k, v in ds.as_arrays().items()}

    def draw_step(self, state: TrainState, idx: int, H: int, W: int) -> StepDraws:
        """The step's draws from the Trainer's generator."""
        with span("train.draw"):
            n = self.opt.num_rays
            emap = None if state.error_maps is None else state.error_maps[idx]
            if self.opt.bg_train == "random":
                bg = torch.rand((n, 3), generator=self.gen, device=self.device)
            else:
                bg = torch.full((n, 3), 1.0 if self.opt.bg_train == "white" else 0.0,
                                device=self.device)
            rays = draw_rays(self.gen, n, H, W, emap, device=self.device)
            return StepDraws(idx=idx, rays=rays, bg=bg, **self._render_draws(n))

    def _render_draws(self, n: int) -> dict:
        """The render's draws for n rays: the march key on the grid path,
        the jitter and importance draws on the dense one."""
        if self.march_cfg is not None:
            return {"march": draw_march_key(self.gen, n, self.device)}
        if self.mip:
            s = self.cfg.num_samples + 1
            return {"jitter": torch.rand((n, s), generator=self.gen, device=self.device),
                    "u": torch.rand((n, s), generator=self.gen, device=self.device)}
        rcfg = self.rcfg
        return {"jitter": torch.rand((n, rcfg.num_steps), generator=self.gen,
                                     device=self.device),
                "u": (torch.rand((n, rcfg.upsample_steps), generator=self.gen,
                                 device=self.device) if rcfg.upsample_steps > 0 else None)}

    def loss_and_grads(self, state: TrainState, arrays, draws: StepDraws) -> StepOut:
        """Render one ray batch and differentiate the MSE w.r.t. the params
        (reference trainer.py:455-506; the dense branch :496-500). Under a
        mesh this rank renders its block of the batch and packs it into
        budget / world slots."""
        images = arrays["images"]
        H, W, C = images.shape[1:]
        with span("train.rays"):
            emap = None if state.error_maps is None else state.error_maps[draws.idx]
            rays = get_rays(arrays["poses"][draws.idx], arrays["intrinsics"], H, W,
                            draws.rays, emap, cone=self.mip)
            gt = images[draws.idx].reshape(H * W, C)[rays["inds"]]
            if C == 4:
                gt = gt[:, :3] * gt[:, 3:] + draws.bg * (1.0 - gt[:, 3:])
        ro, rd, bg = rays["rays_o"], rays["rays_d"], draws.bg
        key, jitter, u = draws.march, draws.jitter, draws.u
        budget, groups = self._current_budget(), self._groups
        if self.mesh is not None:
            ro, rd, gt, bg, key, jitter, u = shard_rays(
                (ro, rd, gt, bg, key, jitter, u), self.mesh)
            budget, groups = budget and budget // groups, 1
        with torch.enable_grad():
            if self.mip:
                out = render_rays_mip(state.params, self.cfg, ro, rd, rays["radii"],
                                      jitter=jitter, u=u, bg_color=bg)
                per_ray = ((out["image"] - gt) ** 2).mean(dim=-1)
                loss = self.cfg.coarse_loss_mult * sum(
                    ((img - gt) ** 2).mean() for img in out["level_images"][:-1])
                loss = loss + per_ray.mean()
                with span("train.backward"):
                    grads = list(torch.autograd.grad(loss, _leaves(state.params)))
                return StepOut(loss.detach(), per_ray.detach(), None, grads, rays["inds"])
            field = make_field(state.params, self.cfg)
            if self.march_cfg is None:
                out = render_rays(field, self.rcfg, ro, rd, jitter=jitter, u=u, bg_color=bg)
            else:
                out = render_rays_grid(
                    field, state.occupancy, self._train_march_cfg(), ro, rd, key=key,
                    bg_color=bg, sample_budget=budget, sample_groups=groups)
            per_ray = ((out["image"] - gt) ** 2).mean(dim=-1)
            loss = per_ray.mean()
            with span("train.backward"):
                grads = list(torch.autograd.grad(loss, _leaves(state.params)))
        loss, per_ray, n_samples = loss.detach(), per_ray.detach(), out.get("n_samples")
        if self.mesh is not None:
            grads = all_mean(grads, self.mesh)
            loss = all_mean([loss], self.mesh)[0]
            per_ray = gather_rays(per_ray, self.mesh)
            if n_samples is not None:
                n_samples = all_sum(n_samples, self.mesh)
        return StepOut(loss, per_ray, n_samples, grads, rays["inds"])

    @torch.no_grad()
    def apply_grads(self, state: TrainState, grads):
        """Adam at the scheduled lr, the EMA of the params and the step
        count, in place on `state`."""
        opt = state.optimizer
        leaves = _leaves(state.params)
        st = opt.state.get(leaves[0])
        count = int(st["step"]) if st else 0
        for group in opt.param_groups:
            group["lr"] = self._lr(count)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        state.global_step += 1
        self._params_version += 1
        if state.ema_params is state.params:   # no EMA (mip-NeRF)
            return
        d = self.opt.ema_decay
        ema = _leaves(state.ema_params)
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(leaves, 1.0 - d))

    @torch.no_grad()
    def apply(self, state: TrainState, out: StepOut, idx: int, H: int, W: int):
        """Adam, the EMA of the params, the error-map and mean-count EMAs,
        and the step count, in place on `state`."""
        with span("train.apply"):
            self.apply_grads(state, out.grads)
            if state.error_maps is not None:
                j, i = out.inds // W, out.inds % W
                coarse = (j * EMAP_SIDE // H) * EMAP_SIDE + (i * EMAP_SIDE // W)
                row = state.error_maps[idx]
                row[coarse] = 0.9 * row[coarse] + 0.1 * out.per_ray
            if state.mean_count is not None and out.n_samples is not None:
                ns = out.n_samples.float()
                state.mean_count = torch.where(state.mean_count <= 0.0, ns,
                                               0.9 * state.mean_count + 0.1 * ns)

    def train_step(self, state: TrainState, arrays, draws: StepDraws):
        """One step; returns its loss (a 0-d device tensor)."""
        with span("train.step"):
            out = self.loss_and_grads(state, arrays, draws)
            H, W = arrays["images"].shape[1:3]
            self.apply(state, out, draws.idx, H, W)
            return out.loss

    # ------------------------------------------------------ poseless step
    def clip_frame(self, H: int, W: int):
        """(scale, rH, rW): the similarity batch's frame of about num_rays
        pixels (reference trainer.py:596-604, provider.py:287)."""
        s = float(np.sqrt(H * W / self.opt.num_rays))
        return s, max(int(H / s), 1), max(int(W / s), 1)

    def draw_clip(self, n: int) -> StepDraws:
        """A poseless step's draws for its n rays."""
        return StepDraws(idx=-1, rays=None, bg=None, **self._render_draws(n))

    def clip_loss_and_grads(self, state: TrainState, pose, intrinsics, H: int, W: int,
                            draws: StepDraws | None = None):
        """(loss, grads) of one poseless similarity batch (reference
        trainer.py:556-594): the clip_frame of an H x W camera with
        intrinsics / scale, rendered from `pose` on white (render_rays_grid
        on the configured march, else render_rays) and scored by
        clip_loss_fn. Every rank of a mesh renders the whole frame from the
        same draws."""
        scale, rH, rW = self.clip_frame(H, W)
        pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=self.device)
        intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32, device=self.device)
        rays = get_all_rays(pose, intrinsics / scale, rH, rW)
        draws = draws or self.draw_clip(rH * rW)
        with torch.enable_grad():
            field = make_field(state.params, self.cfg)
            if self.march_cfg is None:
                out = render_rays(field, self.rcfg, rays["rays_o"], rays["rays_d"],
                                  jitter=draws.jitter, u=draws.u, bg_color=1.0)
            else:
                out = render_rays_grid(field, state.occupancy, self.march_cfg,
                                       rays["rays_o"], rays["rays_d"], key=draws.march,
                                       bg_color=1.0)
            loss = self.clip_loss_fn(out["image"].reshape(rH, rW, 3))
            grads = list(torch.autograd.grad(loss, _leaves(state.params)))
        if self.mesh is not None:
            # the same frame on every rank, but on the card the hash grid's
            # backward sums with atomic adds, whose order differs from rank to
            # rank; the mean hands every rank the same bits, so the replicas
            # stay equal
            grads = all_mean(grads, self.mesh)
        return loss.detach(), grads

    def clip_step(self, state: TrainState, pose, intrinsics, H: int, W: int,
                  draws: StepDraws | None = None):
        """One poseless step: clip_loss_and_grads, then apply_grads. Returns
        the loss (a 0-d device tensor)."""
        loss, grads = self.clip_loss_and_grads(state, pose, intrinsics, H, W, draws)
        self.apply_grads(state, grads)
        return loss

    # ------------------------------------------------------------- loop
    def train(self, train_ds, valid_ds=None, max_epochs: int = 1,
              steps_per_epoch: int | None = None):
        """train_ds: any object with as_arrays() (numpy "poses" (P, 4, 4),
        "images" (P, H, W, C), "intrinsics" (4,)), H, W and __len__."""
        arrays = self._device_arrays(train_ds)
        H, W = train_ds.H, train_ds.W
        if self._fresh:
            if self.opt.error_map:
                self.state.error_maps = torch.full((len(train_ds), EMAP_SIDE**2), 0.1,
                                                   device=self.device)
            self._maybe_resume()
            self._fresh = False
        if self.state.occupancy is not None:
            self.set_occupancy(mark_untrained_grid(
                self.state.occupancy, self.occupancy_cfg, arrays["poses"],
                arrays["intrinsics"], H, W))
        steps = steps_per_epoch or max(len(train_ds), 100)
        rng = np.random.default_rng(self.opt.seed + self.epoch)
        for _ in range(max_epochs):
            self.epoch += 1
            t0 = time.time()
            total = torch.zeros((), device=self.device)
            s = 0
            while s < steps:
                self._maybe_update_occupancy()
                rp = self.opt.rand_pose
                if rp >= 0 and (rp == 0 or s % (rp + 1) == rp):
                    # a similarity batch: every batch at rand_pose 0, else
                    # one per rand_pose supervised ones
                    idxs = [None]
                elif self.opt.scan_steps > 1 and rp < 0:
                    k = min(self.opt.scan_steps, steps - s, self._steps_to_phase_boundary())
                    idxs = rng.integers(len(train_ds), size=k)
                else:
                    idxs = [rng.integers(len(train_ds))]
                for idx in idxs:
                    if idx is None:
                        pose = rand_poses(rng, 1, radius=self.opt.rand_pose_radius)[0]
                        loss = self.clip_step(self.state, pose, arrays["intrinsics"], H, W)
                    else:
                        draws = self.draw_step(self.state, int(idx), H, W)
                        loss = self.train_step(self.state, arrays, draws)
                    total += loss
                    # read on the sweep cadence, where the loop syncs anyway
                    if (self.writer is not None
                            and self.global_step % self.opt.update_extra_interval == 0):
                        self.writer.add_scalar("train/loss", float(loss), self.global_step)
                s += len(idxs)
            avg = float(total) / steps
            self.stats["loss"].append(avg)
            self.log(f"epoch {self.epoch} | loss {avg:.6f} | "
                     f"{steps / (time.time() - t0):.1f} steps/s")
            self.save_checkpoint(full=True)
            if valid_ds is not None and self.epoch % self.opt.eval_interval == 0:
                self.evaluate(valid_ds)

    def _maybe_update_occupancy(self):
        """Every update_extra_interval steps: refresh the host mirror of the
        mean count and sweep the density grid (unless frozen)."""
        state = self.state
        if state.occupancy is None or self.global_step % self.opt.update_extra_interval:
            return
        with span("train.sweep"):
            self._sweep(state)

    def _sweep(self, state):
        """The due update: the host mirror of the mean count, then the
        sweep unless frozen."""
        if state.mean_count is not None:
            self._mean_count_host = float(state.mean_count)
        freeze_at = self.opt.occ_freeze_after
        if freeze_at == 1 and isinstance(freeze_at, int):
            raise ValueError(
                "occ_freeze_after=1 is ambiguous: pass 1.0 for the fraction form "
                "or an absolute step count >= 2")
        if 0 < freeze_at <= 1.0:
            freeze_at = freeze_at * self.opt.iters
        if freeze_at > 0 and self.global_step > freeze_at:
            return
        thresh_cap = None
        tfa = self.opt.occ_thresh_freeze_after
        if 0 < tfa <= 1.0:
            tfa = int(tfa * self.opt.iters)
        if tfa and self.global_step > tfa:
            if self._pinned_thresh is None:
                self._pinned_thresh = min(float(state.occupancy["mean_density"]),
                                          self.occupancy_cfg.density_thresh)
            thresh_cap = self._pinned_thresh
        draws = draw_update(self.gen, state.occupancy, self.occupancy_cfg)
        self.set_occupancy(update_extra_state(
            state.occupancy, self.occupancy_cfg, state.params, self.cfg, draws,
            thresh_cap=thresh_cap, mesh=self.mesh))

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
        """The field's hash tables ("encoder"; the background's stay f32, as
        in the reference) in opt.eval_table_dtype, cached per params object
        and version (a train step updates the params in place). A
        frequency-encoded field (no "encoder") passes through unchanged.

        With the fused MLP backend the MLP weights are also stored in bf16,
        the type the kernel reads, so no call re-casts them."""
        if "encoder" not in params:
            return params
        cached = self._table_cast_cache
        if (cached is None or cached[0] is not params
                or cached[1] != self._params_version):
            dtype = getattr(torch, self.opt.eval_table_dtype)
            cast = dict(params)
            cast["encoder"] = [t.to(dtype) for t in params["encoder"]]
            if self.cfg.mlp_backend == "fused":
                for k in ("sigma_net", "color_net", "bg_net"):
                    if k in params:
                        cast[k] = [w.to(torch.bfloat16) for w in params[k]]
            self._table_cast_cache = (params, self._params_version, cast)
        return self._table_cast_cache[2]

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

    def _planned_ladder(self, occupancy):
        """Occupancy-derived ladder plan for the rounds eval render, planned
        once per occupancy version: an int phase-A length (dt_gamma 0,
        rounded up to whole anchor runs) or a float gamma-ladder span
        (dt_gamma > 0, rounded up to fine-cell edges); 0 = the config's auto
        ladder (reference trainer.py:1103-1155)."""
        mcfg = self.march_cfg
        if (mcfg is None or not self.opt.eval_occ_ladder
                or not self.opt.eval_rounds or not isinstance(occupancy, dict)):
            return 0
        gamma = mcfg.dt_gamma > 0.0
        if gamma:
            if mcfg.gamma_span:
                return 0
        elif not mcfg.coarse_normalized or mcfg.t_a0_steps:
            return 0
        cached = self._ladder_plan
        if cached is not None and cached[0] == self._occ_version:
            return cached[1]
        bits = occupancy["bitfield"].cpu().numpy()
        occ = np.unpackbits(bits, axis=-1, bitorder="little")
        ecfg = self._eval_march_cfg()
        if gamma:
            plan = plan_gamma_span(occ, ecfg)
            if plan:
                cell = 2.0 * min(2.0 ** (ecfg.cascades - 1), ecfg.bound) / ecfg.grid_size
                plan = float(np.ceil(plan / cell) * cell)
                if plan >= 2.0 * np.sqrt(3.0) * max(ecfg.bound, 1.0):
                    plan = 0.0  # no shrink: keep the auto ladder
        else:
            plan = plan_occupied_ladder(occ, ecfg)
            if plan:
                g = phase_a_group_of(ecfg)
                plan = -(-plan // g) * g
        self._ladder_plan = (self._occ_version, plan)
        return plan

    def _frame_march(self, intrinsics, H, W, rd):
        """The march config and occupancy that render_full's chunks march
        with for one frame's rays rd: the eval trims and, on the rounds path,
        the ladder planned from the occupancy and the frame's beam with its
        dilated coarse table. (None, occupancy) without an occupancy grid."""
        mcfg, occupancy = self._eval_march_cfg(), self.occupancy
        if mcfg is None or not self.opt.eval_rounds:
            return mcfg, occupancy
        mcfg = self._apply_ladder_plan(mcfg, self._planned_ladder(occupancy))
        bm = self._frame_beam(intrinsics, H, W, rd)
        if bm > 1:
            mcfg, occupancy = replace(mcfg, beam=bm), self._beamed_occupancy(occupancy)
        return mcfg, occupancy

    def _chunk_renderer(self, mcfg):
        """The eval chunk renderer on march config mcfg: the rounds renderer,
        the one-shot grid render (eval_rounds=False), or the dense
        render_rays when mcfg is None (no occupancy grid; reference
        trainer.py:646-723)."""
        cfg, rcfg = self.cfg, self.rcfg
        if mcfg is None:
            def render_dense(params, occupancy, rays_o, rays_d, bg_color, crop_aabb=None):
                return render_rays(make_field(params, cfg), rcfg, rays_o, rays_d,
                                   bg_color=bg_color, crop_aabb=crop_aabb)

            return render_dense
        if not self.opt.eval_rounds:
            def render_grid(params, occupancy, rays_o, rays_d, bg_color, crop_aabb=None):
                return render_rays_grid(make_field(params, cfg), occupancy, mcfg, rays_o,
                                        rays_d, bg_color=bg_color, crop_aabb=crop_aabb)

            return render_grid
        shade_order = self.opt.shade_order

        def render_chunk(params, occupancy, rays_o, rays_d, bg_color, crop_aabb=None,
                         phase_a=None):
            return render_rays_grid_rounds(
                make_field(params, cfg), occupancy, mcfg, rays_o, rays_d,
                bg_color=bg_color, crop_aabb=crop_aabb, shade_order=shade_order,
                phase_a=phase_a)

        return render_chunk

    def _frame_rays(self, pose, intrinsics, H, W, chunk, pixel_offset, tiles=True):
        """Chunk-padded rays of one frame, (ro, rd, inv): tile-ordered with
        the inverse permutation, or row-major (inv None) padded with rays
        from the origin along (1, 1, 1)."""
        offset = torch.as_tensor(
            pixel_offset if pixel_offset is not None else (0.0, 0.0),
            dtype=torch.float32, device=self.device)
        pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=self.device)
        intrinsics = torch.as_tensor(np.asarray(intrinsics), dtype=torch.float32,
                                     device=self.device)
        if tiles:
            tc = self._tile_layout(H, W, chunk)
            r = rays_from_pixels(pose, intrinsics, tc["i"], tc["j"], offset=offset)
            return r["rays_o"], r["rays_d"], tc["inv"]
        ro, rd = get_padded_rays(pose, intrinsics, H, W, chunk, offset=offset)
        return ro, rd, None

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

        pose: (4, 4) camera-to-world; intrinsics: (fx, fy, cx, cy); crop_aabb:
        optional (6,) box that narrows every ray; pixel_offset: optional
        (dx, dy) subpixel shift. The grid rounds path renders tile-ordered
        chunks (beam and ladder plan as the reference picks them); the
        one-shot grid and the dense paths render row-major chunks (reference
        trainer.py:1157-1282). `frozen` has no effect in eager PyTorch.

        eval_frame_phase_a on the rounds path with dt_gamma 0: one
        march(stop_after="phase_a") of the whole tile-ordered frame, then
        each chunk shades with its slice of those segments (reference
        trainer.py:1003-1030). Only the block marcher has the split; on byte
        bitfields the chunks march whole, as the reference's march ignores
        the split there.

        Under a mesh every rank renders its block of each chunk (chunk /
        world rays, which the frame's beam must divide: a beam never
        straddles two ranks) and the blocks are gathered, so every rank
        returns the whole frame.

        mip-NeRF renders row-major chunks of cone rays through both levels
        at their evenly spaced depths; it takes no crop_aabb."""
        if self.mip:
            return self._render_full_mip(params, pose, intrinsics, H, W, bg_color, crop_aabb,
                                         pixel_offset)
        grid = self.march_cfg is not None
        with torch.no_grad():
            if self.opt.eval_table_dtype != "float32":
                params = self._cast_eval_tables(params)
            if crop_aabb is not None:
                crop_aabb = torch.as_tensor(np.asarray(crop_aabb, np.float32),
                                            device=self.device)
            n = H * W
            chunk = self.rcfg.max_ray_batch
            ro, rd, inv = self._frame_rays(pose, intrinsics, H, W, chunk, pixel_offset,
                                           tiles=grid and self.opt.eval_rounds)
            mcfg, occupancy = self._frame_march(intrinsics, H, W, rd)
            if self.mesh is not None:
                ro, rd, chunk = self._rank_blocks(ro, rd, chunk, mcfg)
            render_chunk = self._chunk_renderer(mcfg)
            split = self._frame_phase_a(ro, rd, occupancy, mcfg, crop_aabb)
            imgs, depths = [], []
            for i in range(0, ro.shape[0], chunk):
                kw = {} if split is None else {
                    "phase_a": {k: v[i : i + chunk] for k, v in split.items()}}
                out = render_chunk(params, occupancy, ro[i : i + chunk], rd[i : i + chunk],
                                   float(bg_color), crop_aabb, **kw)
                imgs.append(out["image"])
                depths.append(out["depth"])
            image, depth = torch.cat(imgs), torch.cat(depths)
            if self.mesh is not None:
                image, depth = self._gather_blocks(image, chunk), self._gather_blocks(depth, chunk)
            image, depth = image[:n], depth[:n]
            if inv is not None:
                image, depth = image[inv], depth[inv]
        return image.reshape(H, W, 3), depth.reshape(H, W)

    @torch.no_grad()
    def _render_full_mip(self, params, pose, intrinsics, H, W, bg_color, crop_aabb,
                         pixel_offset):
        if crop_aabb is not None:
            raise ValueError("mip-NeRF's render takes no crop_aabb: its field has no bound")
        pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=self.device)
        intrinsics = torch.as_tensor(np.asarray(intrinsics), dtype=torch.float32,
                                     device=self.device)
        j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=self.device),
                              torch.arange(W, dtype=torch.float32, device=self.device),
                              indexing="ij")
        i, j = i.reshape(-1), j.reshape(-1)
        if pixel_offset is not None:
            i, j = i + float(pixel_offset[0]), j + float(pixel_offset[1])
        rays = cone_rays(pose, intrinsics, i, j, H)
        chunk = self.rcfg.max_ray_batch
        outs = [render_rays_mip(params, self.cfg, *(rays[k][s:s + chunk]
                                                    for k in ("rays_o", "rays_d", "radii")),
                                bg_color=float(bg_color))
                for s in range(0, H * W, chunk)]
        image = torch.cat([o["image"] for o in outs])
        depth = torch.cat([o["depth"] for o in outs])
        return image.reshape(H, W, 3), depth.reshape(H, W)

    def _rank_blocks(self, ro, rd, chunk, mcfg):
        """This rank's block of every chunk of a frame's rays, and the
        block's size."""
        world = mesh_size(self.mesh)
        if chunk % world:
            raise ValueError(f"the render chunk {chunk} does not divide across {world} ranks")
        block = chunk // world
        if mcfg is not None and mcfg.beam > 1 and block % mcfg.beam:
            raise ValueError(f"a rank's {block} rays of a chunk split the eval beam "
                             f"{mcfg.beam}: beams must not straddle ranks")
        r = self._rank
        return (ro.reshape(-1, world, block, 3)[:, r].reshape(-1, 3),
                rd.reshape(-1, world, block, 3)[:, r].reshape(-1, 3), block)

    def _gather_blocks(self, x, block):
        """Every rank's chunk blocks of a render output back in frame order."""
        world = mesh_size(self.mesh)
        g = gather_rays(x, self.mesh).reshape(world, -1, block, *x.shape[1:])
        return g.transpose(0, 1).reshape(-1, *x.shape[1:])

    def _frame_phase_a(self, ro, rd, occupancy, mcfg, crop_aabb):
        """The frame-wide phase A ({"z", "dt", "valid"}, each (n, K_A)) that
        render_full's chunks shade from under eval_frame_phase_a, or None
        where the frame marches per chunk: the option off, no rounds path,
        dt_gamma > 0 or no block tables."""
        if not (self.opt.eval_frame_phase_a and mcfg is not None and self.opt.eval_rounds
                and mcfg.dt_gamma == 0.0 and occupancy.get("blocks") is not None
                and occupancy.get("blocks_coarse") is not None):
            return None
        m = march(ro, rd, occupancy, mcfg, crop_aabb=crop_aabb, stop_after="phase_a")
        return {k: m[k] for k in ("z", "dt", "valid")}

    def invalidate_render_cache(self):
        """Drop the render's plan and table caches (the ladder plan, the
        eval table cast, the dilated coarse table, the beam guard) and the
        training march configs derived from march_cfg: call after changing
        the march config, the params' layout or the table dtype under them
        (reference trainer.py:915-925)."""
        self._ladder_plan = None
        self._table_cast_cache = None
        self._beam_dilate_cache = None
        self._beam_guard_cache = {}
        self._train_mcfgs = {}

    def evaluate(self, ds, name: str | None = None, use_ema: bool = True):
        """Mean PSNR of render_full over ds's frames (white background),
        with the EMA params unless use_ema=False; writes each frame to
        <workspace>/validation/<name>_epNNNN_NNNN.png, and a new best writes
        the model-only checkpoint (reference trainer.py:1284-1319)."""
        params = self.state.ema_params if use_ema else self.state.params
        arrays = ds.as_arrays()
        meter = PSNRMeter()
        out_dir = os.path.join(self.workspace, "validation")
        os.makedirs(out_dir, exist_ok=True)
        for i in range(len(ds)):
            image, _ = self.render_full(params, arrays["poses"][i], arrays["intrinsics"],
                                        ds.H, ds.W, bg_color=1.0)
            image = image.cpu().numpy()
            gt = np.asarray(arrays["images"][i], dtype=np.float32)
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
            meter.update(image, gt)
            if self._rank == 0:
                self._save_image(os.path.join(
                    out_dir, f"{self.opt.name}_ep{self.epoch:04d}_{i:04d}.png"), image)
        result = meter.measure()
        self.stats["results"].append(result)
        if self.stats["best_result"] is None or result > self.stats["best_result"]:
            self.stats["best_result"] = result
            self.save_checkpoint(best=True)
        meter.write(self.writer, self.global_step, prefix="evaluate")
        self.log(f"eval epoch {self.epoch}: {meter.report()}")
        return result

    def test(self, ds, write_video: bool = True, name: str | None = None):
        """Render ds's camera path with the EMA params into
        <workspace>/results: <name>_NNNN.png frames, <name>_NNNN_depth.png
        depth maps (scaled by their maximum) and, with write_video, an mp4 at
        25 fps. Where no mp4 writer opens, the log says so and the PNGs stay.
        Returns the uint8 frames (reference trainer.py:1321-1366); under a
        mesh every rank renders and rank 0 writes."""
        import cv2

        name = name or self.opt.name
        out_dir = os.path.join(self.workspace, "results")
        os.makedirs(out_dir, exist_ok=True)
        frames = []
        for i in range(len(ds)):
            image, depth = self.render_full(self.state.ema_params, ds.poses[i],
                                            ds.intrinsics, ds.H, ds.W, bg_color=1.0)
            img8 = (np.clip(image.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
            frames.append(img8)
            if self._rank:
                continue
            self._save_image(os.path.join(out_dir, f"{name}_{i:04d}.png"), img8)
            d = depth.cpu().numpy()
            self._save_image(os.path.join(out_dir, f"{name}_{i:04d}_depth.png"),
                             d / max(float(d.max()), 1e-6))
        if write_video and frames and self._rank == 0:
            path = os.path.join(out_dir, f"{name}.mp4")
            h, w = frames[0].shape[:2]
            video = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
            if video.isOpened():
                try:
                    for f in frames:
                        video.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
                finally:
                    video.release()
            else:
                self.log(f"no mp4 writer opened for {path} (cv2 {cv2.__version__}); "
                         "pngs saved")
        return frames

    @staticmethod
    def _save_image(path, img):
        """An image in [0, 1] (or uint8) as an 8-bit PNG."""
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        write_image(path, img)

    # ------------------------------------------------------------ GUI hooks
    def train_gui(self, train_ds, step: int = 16):
        """Run `step` train steps, each after the occupancy update when one
        is due, on images drawn from numpy's default_rng(seed + global_step),
        and report the mean loss and the wall time: the hook the interactive
        viewer drives (reference trainer.py:1368-1391). The device arrays of
        train_ds are built once per dataset."""
        cached = self._gui_arrays
        if cached is None or cached[0] is not train_ds:
            cached = self._gui_arrays = (train_ds, self._device_arrays(train_ds))
        arrays = cached[1]
        H, W = train_ds.H, train_ds.W
        if self._fresh:
            # the reference's first call makes its state here, error maps
            # sized to the dataset; like it, no checkpoint is resumed
            if self.opt.error_map:
                self.state.error_maps = torch.full((len(train_ds), EMAP_SIDE**2), 0.1,
                                                   device=self.device)
            self._fresh = False
        rng = np.random.default_rng(self.opt.seed + self.global_step)
        t0 = time.time()
        total = torch.zeros((), device=self.device)
        for _ in range(step):
            self._maybe_update_occupancy()
            idx = int(rng.integers(len(train_ds)))
            total += self.train_step(self.state, arrays, self.draw_step(self.state, idx, H, W))
        loss = float(total) / step  # waits for the last step
        dt = time.time() - t0
        return {"loss": loss, "time": dt, "steps_per_sec": step / max(dt, 1e-9)}

    def test_gui(self, pose, intrinsics, W, H, bg_color=1.0, spp=1, downscale=1.0,
                 crop_aabb=None, pixel_offset=None, frozen=False):
        """One interactive frame of the EMA params, rendered at `downscale`
        (at least 8 px a side) and resized to W x H with cv2's bilinear
        filter on the host: {"image": (H, W, 3) numpy, "time": s of the
        render and its copy to the host}. pixel_offset: an optional (dx, dy)
        subpixel jitter, which the viewer varies per anti-aliasing pass.
        `spp` and `frozen` have no effect (reference trainer.py:1393-1419)."""
        rh, rw = max(int(H * downscale), 8), max(int(W * downscale), 8)
        intr = np.asarray(intrinsics, np.float32) * downscale
        t0 = time.time()
        image, _ = self.render_full(self.state.ema_params, pose, intr, rh, rw, bg_color,
                                    crop_aabb=crop_aabb, pixel_offset=pixel_offset,
                                    frozen=frozen)
        img = image.cpu().numpy()
        dt = time.time() - t0
        if (rh, rw) != (H, W):
            import cv2

            img = cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR)
        return {"image": img, "time": dt}

    def save_mesh(self, path: str | None = None, resolution: int = 256,
                  threshold: float = 10.0):
        """The iso-surface of the EMA params' density at `threshold` on a
        resolution^3 lattice over the bound cube (marching tetrahedra),
        written as PLY (a path ending in .ply) or OBJ; default path
        <workspace>/meshes/<name>_<epoch>.ply. The density runs through the
        configured MLP backend (the fused kernel under --ff). Returns the
        path (reference trainer.py:1421-1442)."""
        from nerfnav_tpu_torch.models.network import density
        from nerfnav_tpu_torch.utils.mesh import extract_geometry, save_obj, save_ply

        if self.mip:
            raise ValueError("save_mesh samples the bound cube: mip-NeRF's field has no bound")
        params = self.state.ema_params
        verts, faces, _ = extract_geometry(
            lambda x: density(params, x, self.cfg)["sigma"], self.cfg.bound,
            resolution=resolution, threshold=threshold, device=self.device)
        path = path or os.path.join(self.workspace, "meshes",
                                    f"{self.opt.name}_{self.epoch}.ply")
        if self._rank == 0:  # every rank of a mesh extracts the same surface
            (save_ply if path.endswith(".ply") else save_obj)(path, verts, faces)
        self.log(f"mesh saved to {path}: {len(verts)} verts, {len(faces)} faces")
        return path

    # --------------------------------------------------------- checkpoints
    def _ckpt_tree(self):
        """params, optax-shaped Adam state and EMA params, plus error maps
        and occupancy where the state has them."""
        st = self.state
        tree = {"params": st.params,
                "opt_state": ckpt_lib.adam_to_optax(st.optimizer, st.params),
                "ema_params": st.ema_params}
        if st.error_maps is not None:
            tree["error_maps"] = st.error_maps
        if st.occupancy is not None:
            tree["occupancy"] = st.occupancy
        return tree

    def save_checkpoint(self, full: bool = False, best: bool = False):
        """The reference's rolling <name>_epNNNN.npz (full=True adds the
        error maps and occupancy) or the model-only <name>_best.npz (EMA
        params at the root). Under a mesh only rank 0 writes."""
        if self._rank:
            return
        meta = {"epoch": self.epoch, "global_step": self.global_step,
                "stats": dict(self.stats), "grid": ckpt_lib.grid_meta_of(self.cfg)}
        if best:
            ckpt_lib.save_checkpoint(os.path.join(self.ckpt_dir, f"{self.opt.name}_best"),
                                     self.state.ema_params, meta)
            return
        tree = self._ckpt_tree()
        if not full:
            tree.pop("error_maps", None)
            tree.pop("occupancy", None)
        ckpt_lib.save_checkpoint(
            os.path.join(self.ckpt_dir, f"{self.opt.name}_ep{self.epoch:04d}"), tree, meta)
        ckpt_lib.prune_checkpoints(self.ckpt_dir, self.opt.name, self.opt.max_keep_ckpt)

    def _maybe_resume(self):
        """opt.use_checkpoint: "latest", "best", "scratch" or a path."""
        mode = self.opt.use_checkpoint
        if mode == "scratch":
            return
        if mode == "latest":
            path = ckpt_lib.latest_checkpoint(self.ckpt_dir, self.opt.name)
        else:
            p = (os.path.join(self.ckpt_dir, f"{self.opt.name}_best.npz")
                 if mode == "best" else mode)
            path = p if os.path.exists(p) else None
        if path is None:
            self.log("no checkpoint found, training from scratch")
            return
        self.load_checkpoint(path)
        self.log(f"resumed from {path} (epoch {self.epoch})")

    def load_checkpoint(self, path: str):
        """Load a full or model-only ("best") checkpoint of either package
        into the state; returns the load report."""
        st = self.state
        if "best" in os.path.basename(path):
            params, meta, report = ckpt_lib.load_checkpoint(path, st.params)
            ckpt_lib.check_grid_meta(meta, self.cfg, path)
            new = self._init_state(1, params, st.occupancy)
            new.error_maps = st.error_maps
        else:
            tree, meta, report = ckpt_lib.load_checkpoint(path, self._ckpt_tree())
            ckpt_lib.check_grid_meta(meta, self.cfg, path)
            new = self._init_state(1, tree["params"], tree.get("occupancy", st.occupancy))
            ckpt_lib.adam_from_optax(new.optimizer, new.params, tree["opt_state"])
            if not self.mip:
                new.ema_params = tree["ema_params"]
            new.error_maps = tree.get("error_maps", st.error_maps)
        new.mean_count = st.mean_count
        self.state = new
        self.epoch = meta.get("epoch", 0)
        self.state.global_step = meta.get("global_step", 0)
        self.stats.update(meta.get("stats", {}))
        for r in report:
            self.log("ckpt:", r)
        return report
