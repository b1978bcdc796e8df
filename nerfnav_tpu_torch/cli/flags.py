"""Shared command-line flags and their expansion into the port's configs.

Counterpart of nerfnav_tpu/cli/flags.py (`build_parser`,
`_select_mlp_backend`, `make_configs`): the same flags, so a command line
written for the JAX package parses here. `-O` expands per entry point: for
training fp16 MLPs plus the occupancy-grid path; for nav (for_nav=True) fp16
MLPs on the differentiable path, because the pose filter differentiates
through the renderer. Nav also forces the xla MLP chain and the xla
hash-grid backward: the LM filter linearizes in forward mode.
"""

import argparse
import sys
import warnings


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("path", type=str, help="dataset root (transforms json)")
    p.add_argument("-O", action="store_true", help="recommended settings meta-flag")
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the port runs on (cpu only when asked for)")
    # training
    p.add_argument("--iters", type=int, default=30000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--lr_iters", type=int, default=0,
                   help="lr-decay horizon in steps; 0 = --iters")
    p.add_argument("--ckpt", type=str, default="latest")
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--cuda_ray", action="store_true", help="occupancy-grid fast path")
    p.add_argument("--max_steps", type=int, default=1024)
    p.add_argument("--num_steps", type=int, default=512)
    p.add_argument("--upsample_steps", type=int, default=0)
    p.add_argument("--update_extra_interval", type=int, default=16)
    p.add_argument("--max_ray_batch", type=int, default=4096)
    p.add_argument("--samples_per_ray", type=int, default=64,
                   help="static per-ray sample budget of the grid fast path")
    # model
    p.add_argument("--fp16", action="store_true", help="bf16 MLP compute")
    p.add_argument("--grid_levels", type=int, default=None,
                   help="hash-grid levels (default: 16, or 4 under -O)")
    p.add_argument("--grid_level_dim", type=int, default=None,
                   help="features per level (default: 2, or 8 under -O)")
    p.add_argument("--grid_hashmap_log2", type=int, default=None,
                   help="log2 max table rows per level (default: 19, or 17 under -O)")
    p.add_argument("--grid_layout", type=str, default=None, choices=["corner", "cell"],
                   help="table layout: corner (default) or cell (default under -O)")
    p.add_argument("--grid_max_resolution", type=int, default=2048,
                   help="finest hash level resolution per unit bound")
    p.add_argument("--grid_coord_convention", type=str, default="vertex",
                   choices=["vertex", "ngp"], help="hash-lattice convention")
    p.add_argument("--grid_backward", type=str, default="xla", choices=["xla", "sort"],
                   help="hash-table gradient strategy (both run index_add_ here)")
    p.add_argument("--eval_table_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="hash-table dtype for eval rendering")
    p.add_argument("--eval_scan", default=True, action=argparse.BooleanOptionalAction)
    p.add_argument("--eval_occ_ladder", default=True, action=argparse.BooleanOptionalAction)
    p.add_argument("--eval_frame_phase_a", default=False,
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--eval_coarse_segments", type=int, default=12)
    p.add_argument("--eval_coarse_anchors", type=int, default=2)
    p.add_argument("--eval_first_k", action="store_true")
    p.add_argument("--eval_proxy", action="store_true")
    p.add_argument("--eval_beam", type=int, default=0)
    p.add_argument("--ff", action="store_true", help="fused-MLP backend")
    p.add_argument("--tcnn", action="store_true",
                   help="reference-script compatibility flag: selects the fused-MLP "
                   "backend (tinycudann is not a dependency of this port)")
    # dataset
    p.add_argument("--color_space", type=str, default="srgb")
    p.add_argument("--preload", action="store_true",
                   help="accepted for command-line parity; has no effect (the "
                   "trainer always moves the images to the device once)")
    p.add_argument("--bound", type=float, default=2.0)
    p.add_argument("--scale", type=float, default=0.33)
    p.add_argument("--offset", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--dt_gamma", type=float, default=None,
                   help="adaptive stepping; default 1/128, or 0 under -O")
    p.add_argument("--min_near", type=float, default=0.2)
    p.add_argument("--stride_phase", type=str, default="random",
                   choices=["random", "ray_hash"])
    p.add_argument("--coarse_segments", type=int, default=16)
    p.add_argument("--coarse_anchors", type=int, default=3)
    p.add_argument("--density_thresh", type=float, default=10.0)
    p.add_argument("--grid_size", type=int, default=128,
                   help="occupancy grid resolution per cascade")
    p.add_argument("--bg_radius", type=float, default=-1.0)
    p.add_argument("--downscale", type=int, default=1)
    # experimental / gui / clip (parity)
    p.add_argument("--error_map", action="store_true")
    p.add_argument("--rand_pose", type=int, default=-1)
    p.add_argument("--clip_text", type=str, default="")
    p.add_argument("--clip_weights", type=str, default=None,
                   help="a saved CLIPModel state_dict (or .npz of it) for the "
                   "vision tower (training/clip_tower.py shows how to make it)")
    p.add_argument("--clip_text_embed", type=str, default=None,
                   help=".npy text embedding paired with --clip_weights (the text "
                   "tower runs once, offline)")
    p.add_argument("--gui", action="store_true")
    p.add_argument("--W", type=int, default=1920)
    p.add_argument("--H", type=int, default=1080)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--fovy", type=float, default=50.0)
    p.add_argument("--max_spp", type=int, default=64)
    return p


def _select_mlp_backend(opt, for_nav: bool) -> str:
    """--ff / --tcnn pick the fused-MLP kernel, except under nav: the LM
    filter linearizes in forward mode, and the kernel's backward is
    reverse-mode only, so nav runs the xla chain (same math, same
    checkpoints)."""
    if getattr(opt, "tcnn", False):
        print("[flags] --tcnn: tinycudann is not a dependency of this port; running "
              "the fused-MLP backend instead (same architecture and checkpoints as --ff)",
              file=sys.stderr)
    return "fused" if (opt.ff or opt.tcnn) and not for_nav else "xla"


def make_configs(opt, for_nav: bool = False):
    """Expand flags (incl. -O) into (NetworkConfig, RenderConfig,
    OccupancyConfig or None, MarchConfig or None)."""
    from nerfnav_tpu_torch.models.network import NetworkConfig
    from nerfnav_tpu_torch.models.occupancy import OccupancyConfig
    from nerfnav_tpu_torch.models.renderer import RenderConfig
    from nerfnav_tpu_torch.ops.marching import MarchConfig

    if opt.O:
        opt.fp16 = True
        if for_nav:
            opt.cuda_ray = False  # nav needs the differentiable path
            opt.preload = False
        else:
            opt.cuda_ray = True
            opt.preload = True
    # -O picks the flagship grid (cell 4x8 @ 2^17); explicit flags win, and
    # training and nav resolve them alike so checkpoints load
    flagship = bool(opt.O)
    if opt.grid_levels is None:
        opt.grid_levels = 4 if flagship else 16
    if opt.grid_level_dim is None:
        opt.grid_level_dim = 8 if flagship else 2
    if opt.grid_hashmap_log2 is None:
        opt.grid_hashmap_log2 = 17 if flagship else 19
    if opt.grid_layout is None:
        opt.grid_layout = "cell" if flagship else "corner"

    cfg = NetworkConfig(
        bound=opt.bound,
        bg_radius=opt.bg_radius,
        mlp_dtype="bfloat16" if opt.fp16 else "float32",
        mlp_backend=_select_mlp_backend(opt, for_nav),
        grid_levels=opt.grid_levels,
        grid_level_dim=opt.grid_level_dim,
        grid_log2_hashmap_size=opt.grid_hashmap_log2,
        grid_layout=opt.grid_layout,
        grid_max_resolution=opt.grid_max_resolution,
        grid_coord_convention=opt.grid_coord_convention,
        grid_backward="xla" if for_nav else opt.grid_backward,
        # nav differentiates the encode in forward mode (jacfwd), and the
        # hash-grid kernel is reverse-mode only
        grid_backend="xla" if for_nav else "fused",
    )
    rcfg = RenderConfig(num_steps=opt.num_steps, upsample_steps=opt.upsample_steps,
                        min_near=opt.min_near, max_ray_batch=opt.max_ray_batch)
    if opt.dt_gamma is None:
        opt.dt_gamma = 0.0 if opt.O else 1 / 128
    if opt.cuda_ray and opt.dt_gamma != 0.0:
        warnings.warn(f"dt_gamma={opt.dt_gamma}: the block marcher runs its gamma "
                      "ladder (pass --dt_gamma 0 or -O for uniform stepping)", stacklevel=2)
    occ_cfg = march_cfg = None
    if opt.cuda_ray:
        occ_cfg = OccupancyConfig(bound=opt.bound, density_thresh=opt.density_thresh,
                                  min_near=opt.min_near, grid_size=opt.grid_size)
        march_cfg = MarchConfig(bound=opt.bound, max_steps=opt.max_steps,
                                samples_per_ray=opt.samples_per_ray, dt_gamma=opt.dt_gamma,
                                min_near=opt.min_near, grid_size=opt.grid_size,
                                coarse_segments=opt.coarse_segments,
                                coarse_anchors=opt.coarse_anchors)
    return cfg, rcfg, occ_cfg, march_cfg
