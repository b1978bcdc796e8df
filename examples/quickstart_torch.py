"""Dataset-free quickstart of nerfnav_tpu_torch, the PyTorch and CUDA port:
train a NeRF, evaluate it, render a video, and plan a collision-free
trajectory through the trained density field.

The same five stages as examples/quickstart.py, at the same widths and step
counts, through the port. The scene is synthesized on the fly (a textured
sphere with orbit cameras), so no dataset download is needed. The MLPs are
those `-O --ff` picks (bf16 compute, the fused-MLP backend): on the card they
launch the CUDA kernel of nerfnav_tpu_torch/csrc/fused_mlp.cu, built with
nvcc at first use, and the script prints its launches per stage; on the CPU
they run its plain PyTorch version. It runs on the card unless
`--device cpu` asks for the CPU, and raises when no card is present. The
same stages against a real scene: scripts/run_nerf_torch.sh (train) and
scripts/run_sim_torch.sh (navigate).

Usage:
    python examples/quickstart_torch.py                   # on a CUDA card
    python examples/quickstart_torch.py --steps 2000 --hw 128  # better quality
    python examples/quickstart_torch.py --device cpu --steps 30 --hw 24
"""

import argparse
import os
import sys
import tempfile
import time

# runnable from a source checkout without an install
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    """Run the five stages; returns what they measured (val PSNR, the
    planner's losses and clearance, fused-MLP launches and seconds per
    stage)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--hw", type=int, default=40, help="train image side")
    ap.add_argument("--plan_epochs", type=int, default=300,
                    help="epochs of the planner's initial solve")
    ap.add_argument("--out", default=None, help="workspace dir (default: a temp dir)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from nerfnav_tpu_torch.data.provider import DatasetOptions, NeRFDataset
    from nerfnav_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfnav_tpu_torch.device import resolve_device
    from nerfnav_tpu_torch.models.network import NetworkConfig
    from nerfnav_tpu_torch.models.occupancy import OccupancyConfig
    from nerfnav_tpu_torch.models.renderer import RenderConfig, make_field
    from nerfnav_tpu_torch.nav.planner import Planner, PlannerConfig
    from nerfnav_tpu_torch.ops.fused_mlp import fused_mlp
    from nerfnav_tpu_torch.ops.marching import MarchConfig
    from nerfnav_tpu_torch.training import Trainer, TrainerOptions

    device = resolve_device(args.device)
    out = args.out or tempfile.mkdtemp(prefix="nerfnav_quickstart_torch_")
    print(f"[quickstart] workspace: {out}, device: {device}")
    seconds, launches = {}, {}

    def stage(name, t0, n0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t0
        launches[name] = fused_mlp.launches - n0
        return time.perf_counter(), fused_mlp.launches

    t, n = time.perf_counter(), fused_mlp.launches

    # ---- 1. synthesize a scene (textured sphere, orbit cameras) ----------
    scene = os.path.join(out, "scene")
    make_synthetic_scene(scene, n_train=8, n_val=2, H=args.hw, W=args.hw,
                         num_steps=64, device=device)
    train_ds = NeRFDataset(DatasetOptions(path=scene, scale=1.0), "train")
    val_ds = NeRFDataset(DatasetOptions(path=scene, scale=1.0), "val")
    t, n = stage("scene", t, n)

    # ---- 2. train on the occupancy-grid fast path -------------------------
    # the MLPs of -O --ff: bf16 compute through the fused-MLP backend
    cfg = NetworkConfig(bound=1.0, grid_layout="cell", grid_levels=4,
                        grid_level_dim=8, grid_log2_hashmap_size=13,
                        grid_max_resolution=128, mlp_dtype="bfloat16",
                        mlp_backend="fused")
    rcfg = RenderConfig(num_steps=48, upsample_steps=0, min_near=0.05,
                        max_ray_batch=2048)
    opt = TrainerOptions(name="quickstart", workspace=os.path.join(out, "ws"),
                         lr=1e-2, iters=max(args.steps, 1000), num_rays=512,
                         use_checkpoint="scratch", bg_train="white",
                         eval_interval=1)
    tr = Trainer(cfg, rcfg, opt,
                 occupancy_cfg=OccupancyConfig(bound=1.0, min_near=0.05,
                                               density_thresh=5.0,
                                               grid_size=64),
                 march_cfg=MarchConfig(bound=1.0, grid_size=64,
                                       samples_per_ray=32, min_near=0.05),
                 device=device)
    tr.train(train_ds, valid_ds=None, max_epochs=3,
             steps_per_epoch=args.steps // 3)
    t, n = stage("train", t, n)

    # ---- 3. evaluate -------------------------------------------------------
    psnr = float(tr.evaluate(val_ds, use_ema=False))
    print(f"[quickstart] val PSNR after {args.steps} steps: {psnr:.2f} dB")
    t, n = stage("evaluate", t, n)

    # ---- 4. render a held-out orbit video ---------------------------------
    frames = tr.test(val_ds, write_video=True, name="orbit")
    print(f"[quickstart] wrote {len(frames)} frames + video under "
          f"{os.path.join(opt.workspace, 'results')}")
    t, n = stage("render", t, n)

    # ---- 5. plan a trajectory through the trained density -----------------
    field = make_field(tr.state.params, cfg)

    def density_fn(x):
        return field.density_fn(x)[0]

    def state18(pos):
        s = np.zeros(18, np.float32)
        s[0:3] = pos
        s[6:15] = np.eye(3).reshape(-1)
        return s

    pcfg = PlannerConfig(T=12, dt=0.1, epochs_init=args.plan_epochs, astar_fine=40,
                         astar_coarse=20, astar_thresh=2.0)
    planner = Planner(state18([-0.7, 0.0, 0.0]), state18([0.7, 0.0, 0.0]),
                      pcfg, density_fn,
                      workspace=os.path.join(out, "plan"), exp_name="demo",
                      device=device)
    planner.a_star_init()
    losses = planner.learn_init()
    pos = planner.get_full_states()["pos"].detach().cpu().numpy()
    clearance = float(np.sqrt((pos**2).sum(-1)).min())
    t, n = stage("plan", t, n)
    # make_synthetic_scene trains against sphere_field(radius=0.5)
    print(f"[quickstart] planner: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"closest approach to the (r=0.5) sphere: {clearance:.3f}"
          + ("  [CLEAR]" if clearance > 0.5 else "  [COLLISION!]"))
    print(f"[quickstart] trajectory JSON artifacts: {out}/plan/init_poses/demo")
    what = ("fused-MLP kernel launches" if device.type == "cuda"
            else "fused-MLP kernel launches (0 on the CPU: its plain version runs)")
    print(f"[quickstart] {what}: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    print("[quickstart] seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    print("[quickstart] done.")
    return {"psnr": psnr, "losses": losses, "clearance": clearance, "frames": len(frames),
            "workspace": out, "launches": launches, "seconds": seconds}


if __name__ == "__main__":
    main()
