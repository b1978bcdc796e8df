"""Tanks&Temples (intrinsics.txt + pose/*.txt) -> transforms.json.

Counterpart of nerfnav_tpu/scripts/tanks2nerf.py: the scene's 4x4
intrinsics matrix and one 4x4 camera-to-world per image, converted to
OpenGL's axes, centred on the mean camera position and scaled so the
farthest camera sits at distance 1.

Usage: python -m nerfnav_tpu_torch.scripts.tanks2nerf <scene_dir> [--images rgb]
"""

import argparse
import json
import os
import sys

import numpy as np


def convert(path, images="rgb", out_name="transforms.json"):
    """<path>/intrinsics.txt, <path>/pose/<stem>.txt and the images in
    <path>/<images> -> <path>/<out_name>; returns its path."""
    K = np.loadtxt(os.path.join(path, "intrinsics.txt")).reshape(4, 4)
    pose_dir = os.path.join(path, "pose")
    img_dir = os.path.join(path, images)
    names = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    frames = []
    for name in names:
        stem = os.path.splitext(name)[0]
        pose = np.loadtxt(os.path.join(pose_dir, stem + ".txt")).reshape(4, 4)
        # T&T poses are c2w with +z forward / +y down: flip to OpenGL
        c2w = pose.copy()
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1
        frames.append({"file_path": os.path.join(images, name),
                       "transform_matrix": c2w})

    center = np.mean([f["transform_matrix"][:3, 3] for f in frames], axis=0)
    scale = np.max([np.linalg.norm(f["transform_matrix"][:3, 3] - center)
                    for f in frames])
    for f in frames:
        f["transform_matrix"][:3, 3] = (f["transform_matrix"][:3, 3] - center) / max(
            scale, 1e-9
        )

    out = {
        "fl_x": float(K[0, 0]), "fl_y": float(K[1, 1]),
        "cx": float(K[0, 2]), "cy": float(K[1, 2]),
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
    p.add_argument("--images", default="rgb")
    args = p.parse_args(argv)
    convert(args.path, args.images)


if __name__ == "__main__":
    main(sys.argv[1:])
