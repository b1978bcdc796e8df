"""Dataset provider: transforms.json scenes (blender and colmap layouts).

Counterpart of nerfnav_tpu/data/provider.py (`nerf_matrix_to_ngp`,
`ngp_to_nerf_matrix`, `rand_poses`, `_load_image`, `DatasetOptions`,
`NeRFDataset`). The pose conventions, splits, the slerped test path and the
intrinsics are the reference's, line for line; the arrays stay numpy on the
host (`as_arrays`), and the Trainer moves them to its device once.

Images are read and written with cv2 (imported inside the functions that use
it): IMREAD_UNCHANGED, then BGR(A) to RGB(A), uint8 or uint16 scaled to
[0, 1]; `--downscale` resizes with INTER_AREA as the reference does.
"""

import json
import os
from dataclasses import dataclass

import numpy as np


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33, offset=(0, 0, 0)):
    """OpenGL/Blender camera-to-world -> the ngp convention: world axes
    cycled (y, z, x), camera y and z columns flipped, position scaled and
    offset into the [-bound, bound] cube."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def ngp_to_nerf_matrix(pose: np.ndarray, scale: float = 0.33, offset=(0, 0, 0)):
    """Inverse of `nerf_matrix_to_ngp`."""
    return np.array(
        [
            [pose[2, 0], -pose[2, 1], -pose[2, 2], (pose[2, 3] - offset[2]) / scale],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], (pose[0, 3] - offset[0]) / scale],
            [pose[1, 0], -pose[1, 1], -pose[1, 2], (pose[1, 3] - offset[1]) / scale],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def rand_poses(rng: np.random.Generator, size: int, radius: float = 1.0,
               theta_range=(np.pi / 3, 2 * np.pi / 3), phi_range=(0, 2 * np.pi)):
    """(size, 4, 4) float32 ngp camera-to-world poses on an orbit of
    `radius`, looking at the origin, drawn from a numpy Generator."""
    thetas = rng.uniform(*theta_range, size)
    phis = rng.uniform(*phi_range, size)
    centers = np.stack([radius * np.sin(thetas) * np.sin(phis),
                        radius * np.cos(thetas),
                        radius * np.sin(thetas) * np.cos(phis)], axis=-1)
    forward = -centers / np.linalg.norm(centers, axis=-1, keepdims=True)
    up = np.tile(np.array([0.0, 1.0, 0.0]), (size, 1))
    right = np.cross(up, forward)
    right /= np.linalg.norm(right, axis=-1, keepdims=True) + 1e-9
    down = np.cross(forward, right)
    poses = np.zeros((size, 4, 4), dtype=np.float32)
    poses[:, :3, 0] = right
    poses[:, :3, 1] = down
    poses[:, :3, 2] = forward
    poses[:, :3, 3] = centers
    poses[:, 3, 3] = 1.0
    return poses


def _load_image(path: str, downscale: int = 1) -> np.ndarray:
    """An RGB(A) image as float32 in [0, 1], (H, W, 3 or 4)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(f"cv2 cannot read the image {path}")
    if img.ndim == 3 and img.shape[-1] == 4:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA)
    elif img.ndim == 3 and img.shape[-1] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    else:
        img = img.astype(np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if downscale > 1:
        h, w = img.shape[:2]
        img = cv2.resize(img, (w // downscale, h // downscale), interpolation=cv2.INTER_AREA)
    return img


def write_image(path: str, img: np.ndarray):
    """Write an (H, W), (H, W, 3) or (H, W, 4) uint8 or uint16 image, RGB(A)
    channel order, as the file type the path names (PNG here)."""
    import cv2

    if img.ndim == 3 and img.shape[-1] == 4:
        img = cv2.cvtColor(img, cv2.COLOR_RGBA2BGRA)
    elif img.ndim == 3 and img.shape[-1] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    if not cv2.imwrite(path, img):
        raise OSError(f"cv2 could not write {path}")


@dataclass
class DatasetOptions:
    """The flags the provider reads (main_nerf's dataset flags). The layout
    (blender or colmap) is detected from the files."""

    path: str = ""
    scale: float = 0.33
    offset: tuple = (0.0, 0.0, 0.0)
    color_space: str = "srgb"  # "srgb" | "linear"
    downscale: int = 1
    fp16: bool = False
    error_map: bool = False


class NeRFDataset:
    """A transforms.json scene as dense host arrays: poses (N, 4, 4), images
    (N, H, W, C) float32 in [0, 1] (None for the colmap test path),
    intrinsics (fx, fy, cx, cy), H and W (reference provider.py:140-291)."""

    def __init__(self, opt: DatasetOptions, split: str = "train", n_test: int = 10):
        self.opt = opt
        self.split = split
        root = opt.path

        # blender: transforms_<split>.json; colmap: one transforms.json
        tpath = os.path.join(root, f"transforms_{split}.json")
        if os.path.exists(tpath):
            mode = "blender"
        else:
            tpath = os.path.join(root, "transforms.json")
            mode = "colmap"
        if not os.path.exists(tpath):
            raise FileNotFoundError(f"no transforms json under {root}")
        self.mode = mode
        with open(tpath) as f:
            meta = json.load(f)

        frames = meta["frames"]
        if mode == "colmap":
            # sorted for determinism; the first frame is the val split
            frames = sorted(frames, key=lambda d: d["file_path"])
            if split == "train":
                frames = frames[1:]
            elif split == "val":
                frames = frames[:1]

        poses, images = [], []
        if mode == "colmap" and split == "test":
            poses = self._interpolate_test_path(frames, n_test, opt.scale, opt.offset)
            images = None
        else:
            for fr in frames:
                pose = np.array(fr["transform_matrix"], dtype=np.float32)
                poses.append(nerf_matrix_to_ngp(pose, opt.scale, opt.offset))
                fpath = os.path.join(root, fr["file_path"])
                if mode == "blender" and not os.path.splitext(fpath)[1]:
                    fpath += ".png"
                if os.path.exists(fpath):
                    img = _load_image(fpath, opt.downscale)
                    if opt.color_space == "linear":
                        from nerfnav_tpu_torch.training.metrics import srgb_to_linear

                        img[..., :3] = srgb_to_linear(img[..., :3])
                    images.append(img)
            images = np.stack(images) if images else None

        self.poses = np.stack(poses) if isinstance(poses, list) else poses
        self.images = images
        if images is not None:
            self.H, self.W = images.shape[1:3]
        else:
            self.H = int(meta.get("h", 800)) // opt.downscale
            self.W = int(meta.get("w", 800)) // opt.downscale

        ds = opt.downscale
        if "fl_x" in meta or "fl_y" in meta:
            fx = meta.get("fl_x", meta.get("fl_y")) / ds
            fy = meta.get("fl_y", meta.get("fl_x")) / ds
        elif "camera_angle_x" in meta or "camera_angle_y" in meta:
            fx = (self.W / (2 * np.tan(meta["camera_angle_x"] / 2))
                  if "camera_angle_x" in meta else None)
            fy = (self.H / (2 * np.tan(meta["camera_angle_y"] / 2))
                  if "camera_angle_y" in meta else None)
            fx = fx if fx is not None else fy
            fy = fy if fy is not None else fx
        else:
            raise ValueError("cannot derive focal length from transforms json")
        cx = meta.get("cx", self.W / 2) / (ds if "cx" in meta else 1)
        cy = meta.get("cy", self.H / 2) / (ds if "cy" in meta else 1)
        self.intrinsics = np.array([fx, fy, cx, cy], dtype=np.float32)

        if opt.error_map and split == "train" and self.images is not None:
            self.error_map = np.full((len(self.poses), 128 * 128), 0.1, np.float32)
        else:
            self.error_map = None

    @staticmethod
    def _interpolate_test_path(frames, n_test: int, scale: float = 0.33,
                               offset=(0, 0, 0), seed: int = 0):
        """n_test + 1 poses slerped between two frames drawn from a numpy
        Generator seeded with `seed`, at the sine-eased ratio."""
        from scipy.spatial.transform import Rotation, Slerp

        f0, f1 = np.random.default_rng(seed).choice(frames, 2, replace=False)
        p0 = nerf_matrix_to_ngp(np.array(f0["transform_matrix"], dtype=np.float32),
                                scale, offset)
        p1 = nerf_matrix_to_ngp(np.array(f1["transform_matrix"], dtype=np.float32),
                                scale, offset)
        slerp = Slerp([0, 1], Rotation.from_matrix(np.stack([p0[:3, :3], p1[:3, :3]])))
        poses = []
        for i in range(n_test + 1):
            ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = slerp(ratio).as_matrix()
            pose[:3, 3] = (1 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
            poses.append(pose)
        return np.stack(poses)

    def __len__(self):
        return len(self.poses)

    def as_arrays(self):
        """{"poses", "images", "intrinsics"} as numpy arrays; with opt.fp16
        the images are float16, so the targets are rounded as the
        reference's half-precision preload rounds them."""
        imgs = None
        if self.images is not None:
            imgs = self.images.astype(np.float16 if self.opt.fp16 else np.float32)
        return {"poses": self.poses, "images": imgs, "intrinsics": self.intrinsics}

    def dataloader(self, steps_per_epoch: int | None = None, seed: int = 0):
        """Per-step dicts {"index", "pose", "image"}: a random image index
        for the train split, in order otherwise."""
        n = len(self.poses)
        steps = steps_per_epoch or n
        rng = np.random.default_rng(seed)
        for s in range(steps):
            idx = int(rng.integers(n)) if self.split == "train" else s % n
            yield {"index": idx, "pose": self.poses[idx],
                   "image": None if self.images is None else self.images[idx]}
