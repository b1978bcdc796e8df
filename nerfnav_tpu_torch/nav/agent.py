"""Simulated robot: true dynamics plus camera observations rendered from a field.

Counterpart of nerfnav_tpu/nav/agent.py: the true 12-dim state advances
through `drone_dynamics` with optional Gaussian process noise (host numpy
rng, `add_noise_to_state`), the body state maps to a camera pose through
`BODY_TO_CAM`, and the "nerf" backend renders the observation from a
`Field`, densely (`render_rays`, 192 samples) or over an occupancy grid
(`render_rays_grid`). The "blender" backend is a file RPC to a headless
Blender: the pose as JSON in `cache_dir`, then
`blender -b <blend_file> -P <render_script> -- pose.json obs.png`
(sim/blender_render.py by default), and the RGBA PNG it writes composited on
white.
"""

import json
import os
import subprocess
from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from nerfnav_tpu_torch.device import device_const, resolve_device
from nerfnav_tpu_torch.nav.dynamics import DynamicsConfig, drone_dynamics
from nerfnav_tpu_torch.nav.math_utils import vec_to_rot_matrix

# The camera looks along body +x; camera axes are +x right, +y down, +z
# forward (data/rays.py). Columns are the camera axes in body coordinates:
# cam_x = -y_b, cam_y = -z_b, cam_z = +x_b.
BODY_TO_CAM = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32)


def body_state_to_camera_pose(x12):
    """(12,) state tensor -> (4, 4) camera-to-world pose, differentiable
    (the pose filter takes its forward-mode Jacobian through this)."""
    R_cam = vec_to_rot_matrix(x12[6:9]) @ device_const(BODY_TO_CAM.tolist(), x12.device)
    top = torch.cat([R_cam, x12[0:3, None]], dim=1)
    return torch.cat([top, device_const(((0.0, 0.0, 0.0, 1.0),), x12.device)], dim=0)


def add_noise_to_state(state, std, mean=0.0, rng=None):
    """Gaussian process noise on all 12 dims (host numpy)."""
    rng = rng or np.random.default_rng()
    return state + rng.normal(mean, std, size=state.shape).astype(state.dtype)


@dataclass
class AgentConfig:
    dyn: DynamicsConfig = dfield(default_factory=DynamicsConfig)
    H: int = 800
    W: int = 800
    focal: float = 800.0
    backend: str = "nerf"             # "nerf" | "blender"
    blend_file: str = ""
    blender_cmd: str = "blender"
    cache_dir: str = "sim_img_cache"
    render_script: str = ""           # default: sim/blender_render.py


class Agent:
    def __init__(self, start_state, cfg: AgentConfig, field=None, render_chunk=4096,
                 march=None, device="cuda"):
        """field: the Field the nerf backend renders; march: optional
        (occupancy dict, MarchConfig) for the occupancy-grid render. The
        dynamics run on `device` with either backend."""
        if cfg.backend not in ("nerf", "blender"):
            raise ValueError(f"unknown agent backend {cfg.backend!r}")
        if cfg.backend == "blender":
            os.makedirs(cfg.cache_dir, exist_ok=True)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = np.asarray(start_state, np.float32)
        self.field = field
        self.march = march
        self._chunk = render_chunk

    @property
    def intrinsics(self):
        return np.array([self.cfg.focal, self.cfg.focal, self.cfg.W / 2, self.cfg.H / 2],
                        np.float32)

    def step(self, action, noise_std=0.0, noise_mean=0.0, rng=None):
        """Advance the true dynamics (+ noise). Returns (img_uint8, true
        state, camera pose)."""
        with torch.no_grad():
            x = drone_dynamics(torch.as_tensor(self.state, device=self.device),
                               torch.as_tensor(np.asarray(action, np.float32),
                                               device=self.device), self.cfg.dyn)
        x = x.cpu().numpy()
        if noise_std > 0 or noise_mean != 0:
            x = add_noise_to_state(x, noise_std, noise_mean, rng)
        self.state = x.astype(np.float32)
        with torch.no_grad():
            pose = body_state_to_camera_pose(torch.as_tensor(self.state)).numpy()
        return self.get_img(pose), self.state.copy(), pose

    def get_img(self, pose):
        """The (H, W, 3) uint8 observation at a camera pose."""
        if self.cfg.backend == "blender":
            return self._get_img_blender(pose)
        return self._get_img_nerf(pose)

    def _get_img_nerf(self, pose):
        from nerfnav_tpu_torch.data.rays import get_all_rays
        from nerfnav_tpu_torch.models.renderer import (
            RenderConfig, render_rays, render_rays_grid,
        )

        H, W, dev = self.cfg.H, self.cfg.W, self.device
        rays = get_all_rays(torch.as_tensor(np.asarray(pose, np.float32), device=dev),
                            torch.as_tensor(self.intrinsics, device=dev), H, W)
        n, chunk = H * W, self._chunk
        pad = (-n) % chunk
        ro = torch.cat([rays["rays_o"], torch.zeros((pad, 3), device=dev)])
        rd = torch.cat([rays["rays_d"], torch.ones((pad, 3), device=dev)])
        rcfg = RenderConfig(num_steps=192, upsample_steps=0, min_near=0.05)
        outs = []
        with torch.no_grad():
            for i in range(0, n + pad, chunk):
                o, d = ro[i : i + chunk], rd[i : i + chunk]
                if self.march is not None:
                    occ, mcfg = self.march
                    outs.append(render_rays_grid(self.field, occ, mcfg, o, d,
                                                 bg_color=1.0)["image"])
                else:
                    outs.append(render_rays(self.field, rcfg, o, d, bg_color=1.0)["image"])
        img = torch.cat(outs)[:n].reshape(H, W, 3).cpu().numpy()
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def _get_img_blender(self, pose):
        """File RPC to a headless Blender process: writes the request, runs
        Blender on it (a failed run raises) and reads the PNG it wrote."""
        import cv2

        cfg = self.cfg
        pose_path = os.path.join(cfg.cache_dir, "pose.json")
        img_path = os.path.join(cfg.cache_dir, "obs.png")
        with open(pose_path, "w") as f:
            json.dump({"pose": np.asarray(pose, np.float64).tolist(), "res_x": cfg.W,
                       "res_y": cfg.H, "trans": True, "mode": "RGBA"}, f)
        script = cfg.render_script or os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sim",
            "blender_render.py")
        subprocess.run([cfg.blender_cmd, "-b", cfg.blend_file, "-P", script, "--",
                        pose_path, img_path], check=True, capture_output=True)
        img = cv2.imread(img_path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(f"cv2 cannot read Blender's observation {img_path}")
        if img.ndim == 3:  # cv2 reads BGR(A)
            img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[-1] == 4
                               else cv2.COLOR_BGR2RGB)
        img = img.astype(np.float32) / 255.0
        if img.shape[-1] == 4:  # composite on a white background
            img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)
