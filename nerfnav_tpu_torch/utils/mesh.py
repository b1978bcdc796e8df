"""Density-field mesh extraction and OBJ/PLY export.

Counterpart of nerfnav_tpu/utils/mesh.py (reference nerf/utils.py
`extract_geometry` 152-182 and `Trainer.save_mesh` 533-553, which use
pymcubes and trimesh): vectorized marching tetrahedra (each voxel split into
6 tets) with linear edge interpolation, and OBJ/PLY text writers. The
tetrahedra and the writers are numpy, host work in both packages; the
density lattice is evaluated on the device in chunks and read back once.
"""

import os

import numpy as np
import torch

from nerfnav_tpu_torch.device import resolve_device

# Cube corner offsets, index = bit order (x<<2 | y<<1 | z)
_CORNERS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], np.int64
)

# 6-tetrahedra decomposition of the cube (all share the 0-7 diagonal)
_TETS = np.array(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
     [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]], np.int64
)

# For a tet with corner mask m (bit i = corner i inside), the surface crosses
# the edges listed below; triangles are emitted with vertices on those edges.
# Cases with one corner in (or out): 1 triangle; two-in/two-out: 2 triangles.
_TET_EDGES = {
    0b0001: [(0, 1), (0, 2), (0, 3)],
    0b1110: [(0, 1), (0, 3), (0, 2)],
    0b0010: [(1, 0), (1, 3), (1, 2)],
    0b1101: [(1, 0), (1, 2), (1, 3)],
    0b0100: [(2, 0), (2, 1), (2, 3)],
    0b1011: [(2, 0), (2, 3), (2, 1)],
    0b1000: [(3, 0), (3, 2), (3, 1)],
    0b0111: [(3, 0), (3, 1), (3, 2)],
    0b0011: [(0, 2), (0, 3), (1, 3), (1, 3), (1, 2), (0, 2)],
    0b1100: [(0, 2), (1, 3), (0, 3), (1, 3), (0, 2), (1, 2)],
    0b0101: [(0, 1), (2, 3), (0, 3), (0, 1), (2, 1), (2, 3)],
    0b1010: [(0, 1), (0, 3), (2, 3), (0, 1), (2, 3), (2, 1)],
    0b0110: [(1, 0), (1, 3), (2, 3), (1, 0), (2, 3), (2, 0)],
    0b1001: [(1, 0), (2, 3), (1, 3), (1, 0), (2, 0), (2, 3)],
}


def marching_tetrahedra(values: np.ndarray, level: float):
    """values: (X, Y, Z) scalar field -> (verts (V,3) in index coords,
    faces (F,3) int). Vectorized over the cube-tets at once. Only cubes with
    corners on both sides of the level can hold a face, so only those are
    split (in the reference's row-major order, which keeps its output bit
    for bit): at 256^3 a surface crosses a few percent of the cubes."""
    values = np.asarray(values, np.float32)
    nx, ny, nz = values.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    inside = values > level
    corners = [inside[x : x + cx, y : y + cy, z : z + cz] for x, y, z in _CORNERS]
    crossed = np.logical_or.reduce(corners) & ~np.logical_and.reduce(corners)
    base = np.argwhere(crossed).astype(np.int64)[:, None, :]  # (C, 1, 3)

    pa_all, pb_all = [], []
    corner_pos = base + _CORNERS[None]  # (C, 8, 3)
    corner_val = values[
        corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]
    ]  # (C, 8)

    for tet in _TETS:
        pos = corner_pos[:, tet]   # (C, 4, 3)
        val = corner_val[:, tet]   # (C, 4)
        inside = val > level
        mask = (
            inside[:, 0].astype(np.int64)
            | (inside[:, 1] << 1)
            | (inside[:, 2] << 2)
            | (inside[:, 3] << 3)
        )
        for case, edges in _TET_EDGES.items():
            sel = np.flatnonzero(mask == case)
            if len(sel) == 0:
                continue
            # (S, 3*ntri, 3): vertex-triples in face-major order
            pa_all.append(np.stack([pos[sel, a] for a, _ in edges], 1).reshape(-1, 3))
            pb_all.append(np.stack([pos[sel, b] for _, b in edges], 1).reshape(-1, 3))

    if not pa_all:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    pa = np.concatenate(pa_all)  # (3F, 3) int lattice endpoints
    pb = np.concatenate(pb_all)

    # Each surface vertex lies on a lattice edge (pa, pb). Canonicalize the
    # pair order (lexicographic) so the interpolated position is BITWISE
    # identical no matter which tet emitted it — dedup on the integer edge
    # key is then exact (coordinate rounding would leave cracks).
    swap = (
        (pa[:, 0] > pb[:, 0])
        | ((pa[:, 0] == pb[:, 0]) & (pa[:, 1] > pb[:, 1]))
        | ((pa[:, 0] == pb[:, 0]) & (pa[:, 1] == pb[:, 1]) & (pa[:, 2] > pb[:, 2]))
    )
    pa2 = np.where(swap[:, None], pb, pa)
    pb2 = np.where(swap[:, None], pa, pb)
    va = values[pa2[:, 0], pa2[:, 1], pa2[:, 2]]
    vb = values[pb2[:, 0], pb2[:, 1], pb2[:, 2]]
    t = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
    t = np.clip(t, 0.0, 1.0)[:, None]
    flat = pa2 * (1 - t) + pb2 * t

    keys = np.concatenate([pa2, pb2], axis=-1)
    _, idx, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    verts = flat[idx]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[ok]


def extract_geometry(density_fn, bound: float, resolution: int = 256,
                     threshold: float = 10.0, chunk: int = 2 ** 16, device="cuda"):
    """Evaluate density_fn ((N, 3) tensor -> (N,) tensor) on a resolution^3
    lattice over [-bound, bound]^3 (numpy's float32 linspace, x-major) in
    chunks of `chunk` points, the last padded with the origin to a full
    chunk, and iso-surface it at `threshold`. Each chunk's density stays on
    the device until one copy to the host at the end. Returns (verts (V, 3)
    float32 world coordinates, faces (F, 3) int64, field (R, R, R) float32)
    (reference utils/mesh.py:118-145)."""
    dev = resolve_device(device)
    r = resolution
    lin = torch.as_tensor(np.linspace(-bound, bound, r, dtype=np.float32), device=dev)
    n = r ** 3
    out = []
    with torch.no_grad():
        for i in range(0, n, chunk):
            idx = torch.arange(i, i + chunk, device=dev)
            pts = torch.stack([lin[idx // (r * r) % r], lin[idx // r % r], lin[idx % r]], -1)
            pts = torch.where((idx < n)[:, None], pts, 0.0)
            out.append(density_fn(pts).reshape(-1)[: min(chunk, n - i)])
        field = torch.cat(out).float().cpu().numpy().reshape(r, r, r)
    verts, faces = marching_tetrahedra(field, threshold)
    verts = verts * (2 * bound / (r - 1)) - bound
    return verts, faces, field


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:  # OBJ is 1-indexed
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
