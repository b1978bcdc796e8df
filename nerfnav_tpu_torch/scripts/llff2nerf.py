"""LLFF (poses_bounds.npy) -> transforms.json.

Counterpart of nerfnav_tpu/scripts/llff2nerf.py: reads poses_bounds.npy
(N, 17) = a 3x5 pose [R | t | hwf] and the near / far bounds per image,
converts LLFF's [down, right, back] axes to OpenGL's [right, up, back],
moves the mean camera position to the origin and writes one transforms.json,
which the provider (data/provider.py) reads as a colmap scene.

Usage: python -m nerfnav_tpu_torch.scripts.llff2nerf <scene_dir> [--images images]
"""

import argparse
import json
import os
import sys

import numpy as np


def convert(path, images="images", downscale=1, out_name="transforms.json"):
    """<path>/poses_bounds.npy and the images in <path>/<images> ->
    <path>/<out_name>; returns its path."""
    pb = np.load(os.path.join(path, "poses_bounds.npy"))  # (N, 17)
    poses = pb[:, :15].reshape(-1, 3, 5)
    n = poses.shape[0]
    h, w, fl = poses[0, :, 4]
    h, w, fl = h / downscale, w / downscale, fl / downscale

    img_dir = os.path.join(path, images)
    names = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    assert len(names) == n, f"{len(names)} images vs {n} poses"

    frames = []
    for i in range(n):
        m = poses[i, :, :4]  # (3, 4), columns [down, right, back | t]
        # LLFF -> OpenGL: [right, up, back] = [col1, -col0, col2]
        c2w = np.eye(4)
        c2w[:3, 0] = m[:, 1]
        c2w[:3, 1] = -m[:, 0]
        c2w[:3, 2] = m[:, 2]
        c2w[:3, 3] = m[:, 3]
        frames.append({"file_path": os.path.join(images, names[i]),
                       "transform_matrix": c2w})

    # recenter: subtract mean camera position
    center = np.mean([f["transform_matrix"][:3, 3] for f in frames], axis=0)
    for f in frames:
        f["transform_matrix"][:3, 3] -= center

    out = {
        "fl_x": float(fl), "fl_y": float(fl),
        "cx": w / 2, "cy": h / 2, "w": int(w), "h": int(h),
        "aabb_scale": 2,
        "frames": [
            {"file_path": f["file_path"],
             "transform_matrix": f["transform_matrix"].tolist()}
            for f in frames
        ],
    }
    out_path = os.path.join(path, out_name)
    with open(out_path, "w") as fp:
        json.dump(out, fp, indent=2)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path")
    p.add_argument("--images", default="images")
    p.add_argument("--downscale", type=int, default=1)
    args = p.parse_args(argv)
    convert(args.path, args.images, args.downscale)


if __name__ == "__main__":
    main(sys.argv[1:])
