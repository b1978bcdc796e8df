"""Analytic fields, and synthetic datasets rendered from them.

Counterpart of nerfnav_tpu/data/synthetic.py (`sphere_field`,
`cylinder_field`, `textured_sphere_field`, `cluttered_field`,
`make_synthetic_scene`): the `--analytic` nav scene, the tests' fields and a
blender-layout transforms.json scene on disk, with no trained model and no
download. Each closure runs on the device of its input.
"""

import json
import os

import numpy as np
import torch

from nerfnav_tpu_torch.data.provider import ngp_to_nerf_matrix, rand_poses, write_image
from nerfnav_tpu_torch.data.rays import get_padded_rays
from nerfnav_tpu_torch.device import device_const, resolve_device
from nerfnav_tpu_torch.models.renderer import Field, RenderConfig, render_rays


def _norm(x):
    return torch.sqrt((x * x).sum(dim=-1))


def sphere_field(radius=0.5, sigma=200.0, bound=1.0):
    """Opaque sphere with position-dependent color (so views differ)."""

    def density_fn(x):
        return torch.where(_norm(x) < radius, sigma, 0.0), x

    def color_fn(d, geo):
        return torch.clamp(geo * 0.8 + 0.6, 0.0, 1.0)

    return Field(density_fn=density_fn, color_fn=color_fn, bound=bound)


def cylinder_field(radius=0.4, sigma=200.0, bound=1.0):
    """Infinite vertical cylinder, the planner's classic obstacle."""

    def density_fn(x):
        return torch.where(_norm(x[:, :2]) < radius, sigma, 0.0), x

    def color_fn(d, geo):
        return torch.full((d.shape[0], 3), 0.7, device=d.device)

    return Field(density_fn=density_fn, color_fn=color_fn, bound=bound)


def textured_sphere_field(radius=0.5, sigma=300.0, bound=1.0):
    """Opaque sphere with a high-frequency color texture: corners for the
    pose filter's feature front end."""

    def density_fn(x):
        d = torch.sqrt((x * x).sum(dim=-1) + 1e-12)
        return sigma * torch.sigmoid((radius - d) * 40.0), x

    def color_fn(d, geo):
        checker = (torch.sin(20.0 * geo[:, 0]) * torch.sin(20.0 * geo[:, 1])
                   * torch.sin(20.0 * geo[:, 2]))
        r = 0.5 + 0.5 * torch.sin(17.0 * geo[:, 0] + 3.0 * geo[:, 1])
        g = 0.5 + 0.5 * checker
        b = 0.5 + 0.5 * torch.cos(13.0 * geo[:, 2])
        return torch.stack([r, g, b], dim=-1)

    return Field(density_fn=density_fn, color_fn=color_fn, bound=bound)


_SPHERES = ((-0.35, -0.30, -0.28, 0.22),  # x, y, z, r
            (0.40, 0.25, -0.30, 0.14),
            (0.05, 0.45, -0.42, 0.08))
_BOXES = ((0.30, -0.40, -0.38, 0.15, 0.10, 0.12),  # cx, cy, cz, hx, hy, hz
          (-0.30, 0.35, -0.44, 0.08, 0.18, 0.06))


def cluttered_field(sigma=300.0, bound=1.0):
    """A textured floor slab, three spheres and two boxes: structure across
    spatial frequencies."""

    def sdf(x):
        ds = [x[:, 2] + 0.55]  # slab below z = -0.55
        for s in _SPHERES:
            c = device_const(s[:3], x.device)
            ds.append(torch.sqrt(((x - c) ** 2).sum(dim=-1) + 1e-12) - s[3])
        for b in _BOXES:
            c, h = device_const(b[:3], x.device), device_const(b[3:], x.device)
            q = (x - c).abs() - h
            outside = torch.sqrt((torch.clamp(q, min=0.0) ** 2).sum(dim=-1) + 1e-12)
            inside = torch.clamp(q.amax(dim=-1), max=0.0)
            ds.append(outside + inside)
        return torch.stack(ds, dim=-1).amin(dim=-1)

    def density_fn(x):
        return sigma * torch.sigmoid(-sdf(x) * 60.0), x

    def color_fn(d, geo):
        hf = torch.sin(25.0 * geo[:, 0]) * torch.sin(25.0 * geo[:, 1])
        r = 0.5 + 0.5 * torch.sin(11.0 * geo[:, 0] + 5.0 * geo[:, 2])
        g = 0.5 + 0.4 * hf + 0.1 * torch.sin(7.0 * geo[:, 1])
        b = 0.5 + 0.5 * torch.cos(9.0 * (geo[:, 1] + geo[:, 2]))
        return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)

    return Field(density_fn=density_fn, color_fn=color_fn, bound=bound)


def make_synthetic_scene(out_dir: str, field: Field = None, n_train: int = 12,
                         n_val: int = 2, H: int = 64, W: int = 64, fov_x: float = 0.9,
                         radius: float = 1.8, seed: int = 0, num_steps: int = 128,
                         device="cuda"):
    """Write a blender-layout dataset (transforms_{train,val}.json and RGBA
    PNGs) rendered from `field` (default: sphere_field) by the dense
    render_rays on `device`, in chunks of at most 65,536 rays. Poses are
    drawn with rand_poses on an orbit of `radius` and stored in the OpenGL
    convention at scale 1, so the provider reads them back exactly
    (reference synthetic.py:118-188)."""
    field = field or sphere_field()
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fx = W / (2 * np.tan(fov_x / 2))
    intr = torch.tensor([fx, fx, W / 2, H / 2], dtype=torch.float32, device=dev)
    rcfg = RenderConfig(num_steps=num_steps, upsample_steps=0, min_near=0.05)
    os.makedirs(out_dir, exist_ok=True)
    n_r = H * W
    chunk = min(n_r, 65536)

    @torch.no_grad()
    def render_frame(pose):
        ro, rd = get_padded_rays(torch.as_tensor(pose, device=dev), intr, H, W, chunk)
        imgs, ws = [], []
        for s in range(0, ro.shape[0], chunk):
            out = render_rays(field, rcfg, ro[s:s + chunk], rd[s:s + chunk], bg_color=0.0)
            imgs.append(out["image"])
            ws.append(out["weights_sum"])
        return (torch.cat(imgs)[:n_r].reshape(H, W, 3).cpu().numpy(),
                torch.cat(ws)[:n_r].reshape(H, W, 1).cpu().numpy())

    for split, n in (("train", n_train), ("val", n_val)):
        frames = []
        for i, pose in enumerate(rand_poses(rng, n, radius=radius)):
            rgb, alpha = render_frame(pose)
            # un-premultiplied, so the provider's alpha compositing gives rgb
            rgba = np.concatenate([np.divide(rgb, np.maximum(alpha, 1e-4)), alpha], -1)
            fname = f"{split}_{i:03d}.png"
            write_image(os.path.join(out_dir, fname),
                        (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
            frames.append({"file_path": fname,
                           "transform_matrix": ngp_to_nerf_matrix(pose, 1.0).tolist()})
        meta = {"camera_angle_x": float(fov_x), "frames": frames, "h": H, "w": W}
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    return out_dir
