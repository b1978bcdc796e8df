"""The benchmark's scenes, made on the device from the seed.

A frozen copy of the program's analytic field (`data/synthetic.py` of
nerfnav_tpu_torch: `cluttered_field`) with a plain dense renderer, and the
cameras, so that the yardstick does not move when the program's copy
changes. Imports nothing of the program.
"""

import numpy as np
import torch

_SPHERES = ((-0.35, -0.30, -0.28, 0.22),  # x, y, z, r
            (0.40, 0.25, -0.30, 0.14),
            (0.05, 0.45, -0.42, 0.08))
_BOXES = ((0.30, -0.40, -0.38, 0.15, 0.10, 0.12),  # cx, cy, cz, hx, hy, hz
          (-0.30, 0.35, -0.44, 0.08, 0.18, 0.06))


def cluttered(x, sigma=300.0):
    """A textured floor slab, three spheres and two boxes: (density (N,),
    rgb (N, 3)) at points x (N, 3)."""
    ds = [x[:, 2] + 0.55]
    for s in _SPHERES:
        c = torch.tensor(s[:3], device=x.device)
        ds.append(torch.sqrt(((x - c) ** 2).sum(-1) + 1e-12) - s[3])
    for b in _BOXES:
        c, h = torch.tensor(b[:3], device=x.device), torch.tensor(b[3:], device=x.device)
        q = (x - c).abs() - h
        ds.append(torch.sqrt((q.clamp(min=0.0) ** 2).sum(-1) + 1e-12)
                  + q.amax(-1).clamp(max=0.0))
    sdf = torch.stack(ds, -1).amin(-1)
    hf = torch.sin(25.0 * x[:, 0]) * torch.sin(25.0 * x[:, 1])
    rgb = torch.stack([0.5 + 0.5 * torch.sin(11.0 * x[:, 0] + 5.0 * x[:, 2]),
                       0.5 + 0.4 * hf + 0.1 * torch.sin(7.0 * x[:, 1]),
                       0.5 + 0.5 * torch.cos(9.0 * (x[:, 1] + x[:, 2]))], -1)
    return sigma * torch.sigmoid(-sdf * 60.0), rgb.clamp(0.0, 1.0)


FIELDS = {"cluttered": cluttered}


def look_at(centres):
    """(n, 4, 4) float32 camera-to-world poses at `centres` (n, 3) looking at
    the origin, y up: columns right, down, forward (the camera looks along
    its +z, image rows grow along its +y)."""
    fwd = -centres / np.linalg.norm(centres, axis=-1, keepdims=True)
    up = np.broadcast_to(np.array([0.0, 1.0, 0.0]), fwd.shape)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True) + 1e-9
    down = np.cross(fwd, right)
    poses = np.zeros((len(centres), 4, 4), np.float32)
    poses[:, :3, 0], poses[:, :3, 1], poses[:, :3, 2] = right, down, fwd
    poses[:, :3, 3] = centres
    poses[:, 3, 3] = 1.0
    return poses


def sphere_views(n: int, radius: float):
    """n cameras spread evenly (a golden-angle spiral) over the band of
    polar angles [pi/3, 2pi/3] about y, the same set for every seed."""
    k = np.arange(n) + 0.5
    theta = np.arccos(np.cos(np.pi / 3) - k / n * (np.cos(np.pi / 3) - np.cos(2 * np.pi / 3)))
    phi = k * np.pi * (3.0 - np.sqrt(5.0))
    centres = radius * np.stack([np.sin(theta) * np.sin(phi), np.cos(theta),
                                 np.sin(theta) * np.cos(phi)], -1)
    return look_at(centres)


def frame_rays(pose, intrinsics, H: int, W: int):
    """Rays of every pixel of a frame, row-major: (origins, unit directions)."""
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=pose.device),
                          torch.arange(W, dtype=torch.float32, device=pose.device),
                          indexing="ij")
    fx, fy, cx, cy = intrinsics
    d = torch.stack([(i + 0.5 - cx) / fx, (j + 0.5 - cy) / fy, torch.ones_like(i)], -1)
    d = d.reshape(-1, 3)
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    d = d @ pose[:3, :3].T
    return pose[:3, 3].expand(d.shape), d


@torch.no_grad()
def render_field(field, o, d, samples: int, bound: float = 1.0, chunk: int = 2**16):
    """Dense render of an analytic field over the cube: (rgb premultiplied by
    alpha (N, 3), alpha (N,))."""
    rgbs, alphas = [], []
    for s in range(0, len(o), chunk):
        oc, dc = o[s:s + chunk], d[s:s + chunk]
        inv = 1.0 / torch.where(dc.abs() < 1e-9, torch.full_like(dc, 1e-9), dc)
        t0, t1 = (-bound - oc) * inv, (bound - oc) * inv
        near = torch.minimum(t0, t1).amax(-1).clamp(min=0.05)
        far = torch.maximum(torch.maximum(t0, t1).amin(-1), near)
        z = near[:, None] + (far - near)[:, None] * torch.linspace(0, 1, samples, device=o.device)
        dt = torch.cat([z[:, 1:] - z[:, :-1], ((far - near) / samples)[:, None]], -1)
        sig, rgb = field((oc[:, None] + dc[:, None] * z[..., None]).reshape(-1, 3))
        a = 1.0 - torch.exp(-dt * sig.reshape(z.shape))
        t = torch.cumprod(torch.cat([torch.ones_like(a[:, :1]), 1.0 - a[:, :-1] + 1e-10], -1), -1)
        w = a * t
        rgbs.append((w[..., None] * rgb.reshape(*z.shape, 3)).sum(1))
        alphas.append(w.sum(1))
    return torch.cat(rgbs), torch.cat(alphas)


def rgba_views(field, poses, intrinsics, H: int, W: int, samples: int):
    """(P, H, W, 4) float32 RGBA views of a field as a Blender scene stores
    them: colour not premultiplied, alpha the coverage."""
    out = torch.empty((len(poses), H, W, 4), device=poses.device)
    for p in range(len(poses)):
        rgb, a = render_field(field, *frame_rays(poses[p], intrinsics, H, W), samples)
        out[p, ..., :3] = (rgb / a.clamp(min=1e-4)[:, None]).clamp(0.0, 1.0).reshape(H, W, 3)
        out[p, ..., 3] = a.reshape(H, W)
    return out


def intrinsics_of(focal: float, H: int, W: int):
    """(fx, fy, cx, cy) of a pinhole camera at the frame's centre."""
    return [float(focal), float(focal), W / 2.0, H / 2.0]


def fov_focal(focal_800: float, hw: int) -> float:
    """A focal length given at 800 pixels, scaled to a frame of hw pixels."""
    return focal_800 * hw / 800.0

