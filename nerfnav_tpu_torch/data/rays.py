"""Ray generation from camera poses (eval half).

Counterpart of nerfnav_tpu/data/rays.py. Camera convention: pixel
directions (x=(i+0.5-cx)/fx, y=(j+0.5-cy)/fy, z=1) in the camera frame,
rotated by pose[:3, :3]; origins are pose[:3, 3]. Random ray sampling
(`get_rays`, `get_rays_at`) arrives with training (ROADMAP A7).
"""

import numpy as np
import torch


def _pixel_dirs(i, j, intrinsics):
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    xs = (i + 0.5 - cx) / fx
    ys = (j + 0.5 - cy) / fy
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)


def _to_world(dirs, pose):
    """Normalize camera-frame directions and rotate them to the world."""
    dirs = dirs / torch.sqrt((dirs * dirs).sum(dim=-1, keepdim=True))
    rays_d = dirs @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return {"rays_o": rays_o, "rays_d": rays_d}


def get_all_rays(pose, intrinsics, H, W, offset=None):
    """Full-image rays, row-major flat (H*W, 3). pose (4, 4) and intrinsics
    (4,) are float32 tensors on the device the rays should live on."""
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=pose.device),
        torch.arange(W, dtype=torch.float32, device=pose.device),
        indexing="ij",
    )
    i, j = i.reshape(-1), j.reshape(-1)
    if offset is not None:
        i = i + offset[0]
        j = j + offset[1]
    return _to_world(_pixel_dirs(i, j, intrinsics), pose)


def rays_from_pixels(pose, intrinsics, i, j, offset=None):
    """Rays for explicit pixel coordinates i (x), j (y), flat (N,) float32."""
    if offset is not None:
        i = i + offset[0]
        j = j + offset[1]
    return _to_world(_pixel_dirs(i, j, intrinsics), pose)


def tile_order(H, W, tile: int = 64):
    """Permutation mapping tile-major position -> row-major pixel index.

    Returns numpy (perm (H*W,), inv (H*W,)): rays_row_major[perm] is tile
    major; out_tile_major[inv] restores row-major."""
    ny = -(-H // tile)
    nx = -(-W // tile)
    perm = np.empty(H * W, np.int64)
    k = 0
    for ty in range(ny):
        for tx in range(nx):
            ys = np.arange(ty * tile, min((ty + 1) * tile, H))
            xs = np.arange(tx * tile, min((tx + 1) * tile, W))
            block = (ys[:, None] * W + xs[None, :]).reshape(-1)
            perm[k : k + block.size] = block
            k += block.size
    inv = np.empty_like(perm)
    inv[perm] = np.arange(H * W)
    return perm, inv
