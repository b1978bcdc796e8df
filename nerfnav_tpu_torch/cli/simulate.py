"""Navigation simulation: the plan / act / estimate / replan loop.

Counterpart of nerfnav_tpu/cli/simulate.py: `simulate()` runs the mission
(A* warm start and the initial solve happen before it; then per step: next
action -> agent step with process noise -> filter update -> re-root and pop
-> replan, the last `open_loop_steps` steps open loop), `build_sim_parser`
holds the flags, and `main` builds the field (a trainer checkpoint's EMA
params and occupancy, or the `--analytic` textured sphere), the three
closures the nav stack takes (density, render, rays), the planner, the
agent, the filter and, by default, the FusedMPC tick.

    python -m nerfnav_tpu_torch.cli.simulate data/scene -O --workspace ws
    python -m nerfnav_tpu_torch.cli.simulate x --analytic --device cpu --steps 4
"""

import os
import sys

import numpy as np
import torch


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def simulate(traj, agent, filt, steps: int = 20, open_loop_steps: int = 5,
             noise_std: float = 0.0, noise_mean: float = 0.0, seed: int = 0,
             on_step=None, fused=None):
    """The mission loop. Returns the list of (true_state, estimated_state)
    pairs. fused: an optional FusedMPC that runs each closed-loop tick's
    estimate, pop, replan and next action in one pass."""
    rng = np.random.default_rng(seed)
    history = []
    action_next = None
    try:
        for it in range(steps):
            action = _host(traj.get_next_action() if action_next is None else action_next)
            action_next = None
            img, true_state, pose = agent.step(action, noise_std=noise_std,
                                               noise_mean=noise_mean, rng=rng)
            if it < steps - open_loop_steps:
                if fused is not None:
                    x_est, action_next = fused.step(img, action)
                    x_est = _host(x_est)
                else:
                    x_est = filt.estimate_state(img, pose, action)
                    traj.update_state(x_est)
                    traj.learn_update(it)
            else:  # open-loop tail
                x_est = _host(filt.xt) if filt.xt is not None else true_state[:12]
                traj.update_state(true_state[:12])
            history.append((true_state.copy(), np.asarray(x_est).copy()))
            if on_step is not None:
                on_step(it, history[-1])
    except KeyboardInterrupt:
        pass  # an early end keeps the history so far
    return history


def build_sim_parser():
    """The simulate entry's argparse."""
    from nerfnav_tpu_torch.cli.flags import build_parser

    parser = build_parser("nerfnav_tpu_torch navigation simulation", for_nav=True)
    parser.add_argument("--sim_backend", type=str, default="nerf", choices=["nerf", "blender"])
    parser.add_argument("--blend_file", type=str, default="")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--open_loop_steps", type=int, default=5)
    parser.add_argument("--mpc_noise_std", type=float, default=2e-3)
    parser.add_argument("--mpc_noise_mean", type=float, default=0.0)
    parser.add_argument("--start", type=float, nargs=3, default=[0.39, -0.67, 0.2])
    parser.add_argument("--goal", type=float, nargs=3, default=[-0.4, 0.55, 0.16])
    parser.add_argument("--planner_lr", type=float, default=1e-3)
    parser.add_argument("--astar_thresh", type=float, default=0.3,
                        help="A* occupancy threshold on the max-pooled density")
    parser.add_argument("--epochs_init", type=int, default=2500)
    parser.add_argument("--epochs_update", type=int, default=250)
    parser.add_argument("--estimator_lr", type=float, default=1e-3)
    parser.add_argument("--estimator_iters", type=int, default=300)
    parser.add_argument("--estimator_batch", type=int, default=1024)
    parser.add_argument("--obs_res", type=int, default=800)
    parser.add_argument("--obs_focal", type=float, default=800.0)
    parser.add_argument("--analytic", action="store_true",
                        help="run against the built-in analytic scene (no ckpt)")
    parser.add_argument("--fused_cycle", action="store_true", default=True,
                        help="run each closed-loop tick (filter update + waypoint pop + "
                        "replan + next action) as one FusedMPC pass (GN filter only; "
                        "no per-epoch replan or per-step filter artifacts)")
    parser.add_argument("--no_fused", dest="fused_cycle", action="store_false",
                        help="run the unfused four-stage loop, which keeps the "
                        "per-step JSON artifacts")
    parser.add_argument("--poi_backend", type=str, default="orb",
                        choices=["sift", "orb", "corners"],
                        help="keypoint detector of the filter's front end (the filter "
                        "reads only the dilated interest mask); sift is the reference's")
    parser.add_argument("--poi_downscale", type=int, default=2,
                        help="detector downscale (1 = full resolution, the reference's)")
    parser.add_argument("--filter_render", type=str, default="dense",
                        choices=["dense", "grid", "frozen"],
                        help="pose-filter render path: 'dense' = the differentiable "
                        "render_rays; 'grid' = the occupancy-grid render, marched every "
                        "iteration; 'frozen' = march once per update at the predicted "
                        "pose and shade that lattice every LM iteration (GN only). "
                        "grid/frozen need a full checkpoint with occupancy and fall back "
                        "to dense with a warning")
    return parser


def load_field(opt, cfg, device):
    """(Field, occupancy state or None) for the mission: the --analytic
    textured sphere, or the EMA params and occupancy of a trainer checkpoint
    (opt.ckpt: "latest", "best" or a path; a model-only "best" file has no
    occupancy)."""
    from nerfnav_tpu_torch.models.network import init_network
    from nerfnav_tpu_torch.models.occupancy import OccupancyConfig, init_occupancy_state
    from nerfnav_tpu_torch.models.renderer import make_field
    from nerfnav_tpu_torch.training import checkpoint as ckpt_lib

    if opt.analytic:
        from nerfnav_tpu_torch.data.synthetic import textured_sphere_field

        return textured_sphere_field(), None
    params_tmpl = init_network(torch.Generator().manual_seed(0), cfg, device=device)
    ckpt_path = opt.ckpt
    if ckpt_path in ("latest", "best"):
        cdir = os.path.join(opt.workspace, "checkpoints")
        ckpt_path = (os.path.join(cdir, "ngp_best.npz") if opt.ckpt == "best"
                     else ckpt_lib.latest_checkpoint(cdir, "ngp"))
    if ckpt_path is None or not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"no checkpoint at {ckpt_path}; train first or pass --analytic")
    occupancy = None
    if "best" in os.path.basename(ckpt_path):
        params, meta, _ = ckpt_lib.load_checkpoint(ckpt_path, params_tmpl)
        ckpt_lib.check_grid_meta(meta, cfg, ckpt_path)
    else:
        occ_tmpl = init_occupancy_state(
            OccupancyConfig(bound=opt.bound, min_near=opt.min_near, grid_size=opt.grid_size),
            device=device)
        tree, meta, report = ckpt_lib.load_checkpoint(
            ckpt_path, {"ema_params": params_tmpl, "occupancy": occ_tmpl})
        ckpt_lib.check_grid_meta(meta, cfg, ckpt_path)
        if any("ema_params" in r for r in report):
            raise ValueError(f"{ckpt_path}: the EMA params do not fit this config: {report}")
        params = tree["ema_params"]
        if not any("occupancy" in r for r in report):
            occupancy = tree["occupancy"]
    return make_field(params, cfg), occupancy


def nav_closures(opt, field, occupancy, rcfg, device):
    """(density_fn, render_fn, get_rays_fn, get_rays_at_fn, march_fn,
    render_frozen_fn) for the planner and the filter, per --filter_render."""
    from nerfnav_tpu_torch.data.rays import get_all_rays, get_rays_at
    from nerfnav_tpu_torch.models.renderer import (
        render_rays, render_rays_frozen, render_rays_grid,
    )
    from nerfnav_tpu_torch.ops.marching import MarchConfig, march

    def density_fn(x):
        return field.density_fn(x)[0]

    def render_dense(ro, rd):
        return render_rays(field, rcfg, ro, rd, bg_color=1.0)

    render_fn, march_fn, render_frozen_fn = render_dense, None, None
    if opt.filter_render in ("grid", "frozen") and occupancy is None:
        print(f"[simulate] WARNING: --filter_render {opt.filter_render} needs a full "
              "checkpoint with occupancy state; using dense", file=sys.stderr)
    elif opt.filter_render in ("grid", "frozen"):
        mcfg = MarchConfig(bound=opt.bound, max_steps=opt.max_steps, samples_per_ray=64,
                           min_near=opt.min_near, grid_size=opt.grid_size)
        if opt.filter_render == "grid":
            def render_fn(ro, rd):
                return render_rays_grid(field, occupancy, mcfg, ro, rd, bg_color=1.0)
        else:
            def march_fn(ro, rd):
                return march(ro, rd, occupancy, mcfg)

            def render_frozen_fn(ro, rd, z, dt, valid):
                return render_rays_frozen(field, opt.bound, ro, rd, z, dt, valid,
                                          bg_color=1.0)

    H = W = opt.obs_res
    intr = torch.tensor([opt.obs_focal, opt.obs_focal, W / 2, H / 2], device=device)

    def get_rays_fn(pose):
        return get_all_rays(pose, intr, H, W)

    def get_rays_at_fn(pose, inds):
        return get_rays_at(pose, intr, W, inds)

    return density_fn, render_fn, get_rays_fn, get_rays_at_fn, march_fn, render_frozen_fn


def build_mission(opt, device):
    """Everything `main` runs: returns (traj, agent, filt, fused or None),
    with the A* warm start and the initial solve not yet run."""
    from nerfnav_tpu_torch.cli.flags import make_configs
    from nerfnav_tpu_torch.models.renderer import RenderConfig
    from nerfnav_tpu_torch.nav.agent import Agent, AgentConfig, body_state_to_camera_pose
    from nerfnav_tpu_torch.nav.dynamics import DynamicsConfig
    from nerfnav_tpu_torch.nav.estimator import Estimator, EstimatorConfig
    from nerfnav_tpu_torch.nav.fused import FusedMPC
    from nerfnav_tpu_torch.nav.planner import Planner, PlannerConfig

    opt.cuda_ray = False
    cfg, _, _, _ = make_configs(opt, for_nav=True)
    # the nav render: fewer samples than full quality, differentiable
    rcfg = RenderConfig(num_steps=128, upsample_steps=0, min_near=opt.min_near,
                        max_ray_batch=opt.max_ray_batch)
    field, occupancy = load_field(opt, cfg, device)
    density_fn, render_fn, get_rays_fn, get_rays_at_fn, march_fn, render_frozen_fn = \
        nav_closures(opt, field, occupancy, rcfg, device)

    H = W = opt.obs_res
    dyn = DynamicsConfig(dt=2.0 / opt.steps)
    pcfg = PlannerConfig(T=opt.steps, dt=dyn.dt, lr=opt.planner_lr,
                         epochs_init=opt.epochs_init, epochs_update=opt.epochs_update,
                         bound=min(opt.bound, 1.0), astar_thresh=opt.astar_thresh)
    start18 = np.zeros(18, np.float32)
    start18[0:3] = opt.start
    start18[6:15] = np.eye(3).reshape(-1)
    end18 = start18.copy()
    end18[0:3] = opt.goal
    ws = opt.workspace
    os.makedirs(ws, exist_ok=True)
    # the fused tick is headless: no per-epoch replan artifacts
    traj = Planner(start18, end18, pcfg, density_fn,
                   workspace=None if opt.fused_cycle else ws, exp_name="sim", device=device)
    start12 = np.concatenate([start18[0:6], np.zeros(3), start18[15:18]]).astype(np.float32)
    acfg = AgentConfig(dyn=dyn, H=H, W=W, focal=opt.obs_focal, backend=opt.sim_backend,
                       blend_file=opt.blend_file)
    agent = Agent(start12, acfg, field=field, device=device)
    ecfg = EstimatorConfig(lr=opt.estimator_lr, n_iters=opt.estimator_iters,
                           batch_size=opt.estimator_batch, poi_backend=opt.poi_backend,
                           poi_downscale=opt.poi_downscale)
    filt = Estimator(ecfg, dyn, render_fn, get_rays_fn, body_state_to_camera_pose,
                     workspace=ws, get_rays_at_fn=get_rays_at_fn, march_fn=march_fn,
                     render_frozen_fn=render_frozen_fn, device=device, seed=opt.seed)
    filt.set_initial_state(start12)
    fused = FusedMPC(filt, traj, H, W) if opt.fused_cycle else None
    return traj, agent, filt, fused


def main(argv=None):
    from nerfnav_tpu_torch.device import resolve_device

    opt = build_sim_parser().parse_args(argv)
    device = resolve_device(opt.device)
    traj, agent, filt, fused = build_mission(opt, device)
    print("[simulate] A* warm start...")
    traj.a_star_init()
    print("[simulate] initial trajectory optimization...")
    traj.learn_init()

    def on_step(it, pair):
        true_s, est_s = pair
        err = np.linalg.norm(true_s[0:3] - est_s[0:3])
        print(f"[simulate] step {it}: pos err {err:.4f}  true {true_s[0:3]}")

    history = simulate(traj, agent, filt, steps=opt.steps,
                       open_loop_steps=opt.open_loop_steps, noise_std=opt.mpc_noise_std,
                       noise_mean=opt.mpc_noise_mean, seed=opt.seed, on_step=on_step,
                       fused=fused)
    goal_err = np.linalg.norm(history[-1][0][0:3] - np.asarray(opt.goal))
    print(f"[simulate] done: {len(history)} steps, final goal error {goal_err:.4f}")
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
