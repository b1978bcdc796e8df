"""HyperNeRF dataset (scene.json + camera/*.json) -> transforms.json.

Counterpart of nerfnav_tpu/scripts/hyper2nerf.py: reads the Nerfies /
HyperNeRF layout (dataset.json: the image ids; scene.json: the scene's
center and scale; camera/<id>.json: orientation, position, focal_length,
principal_point) and writes transforms.json with a time value per frame,
the images taken from rgb/<downscale>x/.

Usage: python -m nerfnav_tpu_torch.scripts.hyper2nerf <scene_dir> [--downscale 2]
"""

import argparse
import json
import os
import sys

import numpy as np


def convert(path, downscale=2, out_name="transforms.json"):
    """<path>'s HyperNeRF files -> <path>/<out_name>; returns its path. Ids
    without a camera file are skipped."""
    with open(os.path.join(path, "dataset.json")) as f:
        dataset = json.load(f)
    with open(os.path.join(path, "scene.json")) as f:
        scene = json.load(f)
    center = np.asarray(scene.get("center", [0, 0, 0]))
    scale = float(scene.get("scale", 1.0))

    ids = dataset.get("ids", [])
    frames = []
    fl = cx = cy = None
    for i, fid in enumerate(ids):
        cam_path = os.path.join(path, "camera", f"{fid}.json")
        if not os.path.exists(cam_path):
            continue
        with open(cam_path) as f:
            cam = json.load(f)
        # orientation is world->camera row-major; position is camera center
        R = np.asarray(cam["orientation"]).T  # camera->world
        t = (np.asarray(cam["position"]) - center) * scale
        c2w = np.eye(4)
        c2w[:3, :3] = R
        # Nerfies camera: +z forward, +y down -> OpenGL: flip y, z
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1
        c2w[:3, 3] = t
        fl = float(cam["focal_length"]) / downscale
        pp = cam.get("principal_point", [0, 0])
        cx, cy = pp[0] / downscale, pp[1] / downscale
        frames.append(
            {
                "file_path": os.path.join("rgb", f"{downscale}x", f"{fid}.png"),
                "transform_matrix": c2w.tolist(),
                "time": i / max(len(ids) - 1, 1),
            }
        )

    out = {
        "fl_x": fl, "fl_y": fl, "cx": cx, "cy": cy,
        "aabb_scale": 2,
        "frames": frames,
    }
    out_path = os.path.join(path, out_name)
    with open(out_path, "w") as fp:
        json.dump(out, fp, indent=2)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path")
    p.add_argument("--downscale", type=int, default=2)
    args = p.parse_args(argv)
    convert(args.path, args.downscale)


if __name__ == "__main__":
    main(sys.argv[1:])
