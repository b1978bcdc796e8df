"""Ray generation from camera poses.

Counterpart of nerfnav_tpu/data/rays.py. Camera convention: pixel
directions (x=(i+0.5-cx)/fx, y=(j+0.5-cy)/fy, z=1) in the camera frame,
rotated by pose[:3, :3]; origins are pose[:3, 3]. `get_rays` samples a
training batch from explicit draws (`RayDraws`, made by `draw_rays` from a
torch.Generator), so a test can inject the JAX package's draws.
`get_rays_at` gives the rays of explicit flat pixel indices, the pose
filter's per-iteration path. `cone_rays` gives mip-NeRF's rays: directions
left at unit camera depth and each pixel's cone radius.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

EMAP_SIDE = 128  # error-map bins per image side (reference utils.py:78-98)


class RayDraws(NamedTuple):
    """The random draws of one ray batch: uniform flat pixel indices (n,),
    or, with an error map, coarse bins (n,) drawn in proportion to the
    error and a jitter (n, 2) uniform in [0, 1) inside each bin."""
    inds: Optional[torch.Tensor] = None
    bins: Optional[torch.Tensor] = None
    jitter: Optional[torch.Tensor] = None


def draw_rays(generator, n_rays: int, H: int, W: int, error_map=None,
              device=None) -> RayDraws:
    """RayDraws for get_rays from a torch.Generator: randint over the
    pixels, or a categorical draw over the bins with weights error_map +
    1e-8 (the reference's categorical over log(error_map + 1e-8))."""
    if error_map is None:
        return RayDraws(inds=torch.randint(0, H * W, (n_rays,), generator=generator,
                                           device=device))
    bins = torch.multinomial(error_map + 1e-8, n_rays, replacement=True,
                             generator=generator)
    return RayDraws(bins=bins, jitter=torch.rand((n_rays, 2), generator=generator,
                                                 device=error_map.device))


def get_rays(pose, intrinsics, H: int, W: int, draws: RayDraws, error_map=None,
             cone: bool = False):
    """World-space rays of a sampled pixel batch: {"rays_o", "rays_d" (n, 3),
    "inds" (n,) flat pixel indices}. With an error map the pixels come from
    the draws' coarse bins plus jitter, else from its uniform indices. With
    `cone`, mip-NeRF's rays (`cone_rays`: directions not normalised, and
    "radii" (n, 1))."""
    if error_map is None:
        inds = draws.inds
    else:
        cy, cx = draws.bins // EMAP_SIDE, draws.bins % EMAP_SIDE
        fy = torch.clamp(((cy.float() + draws.jitter[:, 0]) / EMAP_SIDE * H).long(), 0, H - 1)
        fx = torch.clamp(((cx.float() + draws.jitter[:, 1]) / EMAP_SIDE * W).long(), 0, W - 1)
        inds = fy * W + fx
    j, i = inds // W, inds % W
    if cone:
        return {**cone_rays(pose, intrinsics, i.float(), j.float(), H), "inds": inds}
    rays = _to_world(_pixel_dirs(i.float(), j.float(), intrinsics), pose)
    return {**rays, "inds": inds}


def cone_rays(pose, intrinsics, i, j, H: int):
    """mip-NeRF's rays through pixels (i, j) (n,) float32 of an H-row frame
    (google/mipnerf `datasets.py` `_generate_rays`): {"rays_o", "rays_d" (the
    camera-frame direction at unit depth, rotated elementwise: t is depth
    along the optical axis), "radii" (n, 1)}. A pixel's radius is 2 /
    sqrt(12) times the distance between the directions of its row and the
    next (of rows H - 3 and H - 2 for the last row, as mipnerf pads it)."""
    def directions(rows):
        d = _pixel_dirs(i, rows, intrinsics)
        return (d[:, None, :] * pose[:3, :3]).sum(dim=-1)

    rays_d = directions(j)
    below = torch.where(j == H - 1, j - 2.0, j)
    dx = torch.sqrt(((directions(below) - directions(below + 1.0)) ** 2).sum(dim=-1))
    return {"rays_o": pose[:3, 3].expand(rays_d.shape), "rays_d": rays_d,
            "radii": dx[:, None] * 2.0 / math.sqrt(12.0)}


def get_rays_at(pose, intrinsics, W: int, inds):
    """Rays at flat row-major pixel indices inds (n,): directions only at
    those pixels, differentiable w.r.t. pose. {"rays_o", "rays_d", "inds"}."""
    j, i = inds // W, inds % W
    rays = _to_world(_pixel_dirs(i.float(), j.float(), intrinsics), pose)
    return {**rays, "inds": inds}


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


def get_padded_rays(pose, intrinsics, H, W, chunk, offset=None):
    """get_all_rays as (rays_o, rays_d), padded to a whole number of
    `chunk`-ray chunks with rays from the origin along (1, 1, 1)."""
    r = get_all_rays(pose, intrinsics, H, W, offset=offset)
    pad = (-H * W) % chunk
    return (torch.cat([r["rays_o"], torch.zeros((pad, 3), device=pose.device)]),
            torch.cat([r["rays_d"], torch.ones((pad, 3), device=pose.device)]))


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
