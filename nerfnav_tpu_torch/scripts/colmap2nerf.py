"""COLMAP -> transforms.json converter.

Counterpart of nerfnav_tpu/scripts/colmap2nerf.py: optionally extracts a
video's frames (ffmpeg) and runs COLMAP (feature_extractor, the matcher,
mapper, model_converter) on the image folder, then converts the text model
to one transforms.json: per-image sharpness (variance of the Laplacian),
the world's up vector rotated to +z, the cameras' centre of attention moved
to the origin and the mean camera distance scaled to 4. The provider
(data/provider.py) reads it as a colmap scene. Numpy and cv2 only.

Usage:
  python -m nerfnav_tpu_torch.scripts.colmap2nerf --images <dir> --text <colmap_text>
  python -m nerfnav_tpu_torch.scripts.colmap2nerf --images <dir> --run_colmap
  python -m nerfnav_tpu_torch.scripts.colmap2nerf --video v.mp4 --images <dir> -y \\
      --run_colmap --colmap_matcher sequential
"""

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np


def qvec2rotmat(q):
    """COLMAP quaternion (w,x,y,z) -> rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def sharpness(path):
    """Variance-of-Laplacian focus measure. An image cv2 cannot read
    raises (the JAX package scores it 100.0)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cv2 cannot read the image {path} to score its sharpness")
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return float(cv2.Laplacian(gray, cv2.CV_64F).var())


def rotmat_between(a, b):
    """Rotation taking unit vector a to unit vector b (Rodrigues)."""
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-9:
        return np.eye(3) if c > 0 else -np.eye(3)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K / (1 + c)


def closest_point_2_lines(oa, da, ob, db):
    """Midpoint of the closest segment between two rays and its weight
    (the squared sine of the angle between them)."""
    da, db = da / np.linalg.norm(da), db / np.linalg.norm(db)
    c = np.cross(da, db)
    denom = np.linalg.norm(c) ** 2
    t = ob - oa
    ta = np.linalg.det([t, db, c]) / (denom + 1e-10)
    tb = np.linalg.det([t, da, c]) / (denom + 1e-10)
    ta, tb = max(ta, 0), max(tb, 0)
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def run_ffmpeg(video, images_dir, fps=3.0, time_slice="", yes=False):
    """Extract a video's frames into images_dir with ffmpeg: sampled at
    fps, within an optional "t1,t2" window in seconds, as top-quality JPEG.
    The images folder is replaced (asked first unless yes=True). Video pairs
    with --colmap_matcher sequential."""
    import shutil

    fps = float(fps) or 1.0
    print(f"ffmpeg: video={video} -> {images_dir} at fps={fps}")
    if not yes:
        ans = input(
            f"warning! folder '{images_dir}' will be deleted/replaced. "
            "continue? (Y/n)"
        ).lower().strip()
        if (ans + "y")[:1] != "y":
            sys.exit(1)
    shutil.rmtree(images_dir, ignore_errors=True)
    os.makedirs(images_dir, exist_ok=True)
    vf = f"fps={fps}"
    if time_slice:
        start, end = time_slice.split(",")
        vf += f",select='between(t\\,{start}\\,{end})'"
    subprocess.run(
        ["ffmpeg", "-i", video, "-qscale:v", "1", "-qmin", "1", "-vf", vf,
         os.path.join(images_dir, "%04d.jpg")],
        check=True,
    )


def run_colmap(images_dir, out_dir, colmap_cmd="colmap", matcher="exhaustive"):
    """COLMAP's pipeline: feature_extractor, the matcher, mapper, then the
    model as text; returns the text model's folder."""
    db = os.path.join(out_dir, "colmap.db")
    sparse = os.path.join(out_dir, "sparse")
    text = os.path.join(out_dir, "colmap_text")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(text, exist_ok=True)
    subprocess.run([colmap_cmd, "feature_extractor", "--database_path", db,
                    "--image_path", images_dir], check=True)
    subprocess.run([colmap_cmd, f"{matcher}_matcher", "--database_path", db],
                   check=True)
    subprocess.run([colmap_cmd, "mapper", "--database_path", db,
                    "--image_path", images_dir, "--output_path", sparse],
                   check=True)
    subprocess.run([colmap_cmd, "model_converter", "--input_path",
                    os.path.join(sparse, "0"), "--output_path", text,
                    "--output_type", "TXT"], check=True)
    return text


def convert(text_dir, images_dir, out_path, aabb_scale=16, skip_early=0,
            keep_colmap_coords=False):
    """A COLMAP text model (cameras.txt, images.txt) -> transforms.json at
    out_path; returns out_path."""
    # cameras.txt
    with open(os.path.join(text_dir, "cameras.txt")) as f:
        cam = {}
        for line in f:
            if line.startswith("#"):
                continue
            els = line.split()
            cam["w"], cam["h"] = float(els[2]), float(els[3])
            cam["fl_x"] = cam["fl_y"] = float(els[4])
            cam["cx"], cam["cy"] = cam["w"] / 2, cam["h"] / 2
            cam["k1"] = cam["k2"] = cam["p1"] = cam["p2"] = 0.0
            model = els[1]
            if model == "SIMPLE_PINHOLE":
                cam["cx"], cam["cy"] = float(els[5]), float(els[6])
            elif model == "PINHOLE":
                cam["fl_y"] = float(els[5])
                cam["cx"], cam["cy"] = float(els[6]), float(els[7])
            elif model in ("SIMPLE_RADIAL", "RADIAL"):
                cam["cx"], cam["cy"] = float(els[5]), float(els[6])
                cam["k1"] = float(els[7])
                if model == "RADIAL":
                    cam["k2"] = float(els[8])
            elif model == "OPENCV":
                cam["fl_y"] = float(els[5])
                cam["cx"], cam["cy"] = float(els[6]), float(els[7])
                cam["k1"], cam["k2"] = float(els[8]), float(els[9])
                cam["p1"], cam["p2"] = float(els[10]), float(els[11])
            break

    angle_x = 2 * math.atan(cam["w"] / (2 * cam["fl_x"]))
    angle_y = 2 * math.atan(cam["h"] / (2 * cam["fl_y"]))

    frames = []
    with open(os.path.join(text_dir, "images.txt")) as f:
        i = 0
        for line in f:
            if line.startswith("#"):
                continue
            i += 1
            if i < skip_early * 2:
                continue
            if i % 2 == 1:  # odd lines: pose; even: 2D points
                els = line.split()
                name = "_".join(els[9:])
                qvec = np.array([float(v) for v in els[1:5]])
                tvec = np.array([float(v) for v in els[5:8]])
                R = qvec2rotmat(-qvec)
                t = tvec.reshape(3, 1)
                m = np.concatenate([np.concatenate([R, t], 1),
                                    np.array([[0, 0, 0, 1.0]])], 0)
                c2w = np.linalg.inv(m)
                if not keep_colmap_coords:
                    c2w[0:3, 2] *= -1  # flip the y and z axis
                    c2w[0:3, 1] *= -1
                    c2w = c2w[[1, 0, 2, 3], :]
                    c2w[2, :] *= -1  # world z up
                frames.append(
                    {
                        "file_path": os.path.join(images_dir, name),
                        "sharpness": sharpness(os.path.join(images_dir, name)),
                        "transform_matrix": c2w,
                    }
                )

    if not keep_colmap_coords:
        # rotate world up to +z
        up = sum(f["transform_matrix"][0:3, 1] for f in frames)
        Rup = rotmat_between(up, np.array([0.0, 0.0, 1.0]))
        T = np.eye(4)
        T[:3, :3] = Rup
        for f in frames:
            f["transform_matrix"] = T @ f["transform_matrix"]
        # center of attention: point closest to all camera forward rays
        totw, totp = 0.0, np.zeros(3)
        for f in frames:
            mf = f["transform_matrix"][0:3, :]
            for g in frames:
                mg = g["transform_matrix"][0:3, :]
                p, w = closest_point_2_lines(mf[:, 3], mf[:, 2], mg[:, 3], mg[:, 2])
                if w > 0.00001:
                    totp += p * w
                    totw += w
        if totw > 0:
            totp /= totw
        for f in frames:
            f["transform_matrix"][0:3, 3] -= totp
        avglen = np.mean([np.linalg.norm(f["transform_matrix"][0:3, 3])
                          for f in frames])
        for f in frames:
            f["transform_matrix"][0:3, 3] *= 4.0 / max(avglen, 1e-9)

    out = {
        "camera_angle_x": angle_x,
        "camera_angle_y": angle_y,
        "fl_x": cam["fl_x"], "fl_y": cam["fl_y"],
        "k1": cam["k1"], "k2": cam["k2"], "p1": cam["p1"], "p2": cam["p2"],
        "cx": cam["cx"], "cy": cam["cy"], "w": cam["w"], "h": cam["h"],
        "aabb_scale": aabb_scale,
        "frames": [
            {
                "file_path": f["file_path"],
                "sharpness": f["sharpness"],
                "transform_matrix": f["transform_matrix"].tolist(),
            }
            for f in frames
        ],
    }
    with open(out_path, "w") as fp:
        json.dump(out, fp, indent=2)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", required=True)
    p.add_argument("--video", default=None,
                   help="input video: frames are ffmpeg-extracted into "
                   "--images first (use --colmap_matcher sequential for video)")
    p.add_argument("--video_fps", type=float, default=3.0)
    p.add_argument("--time_slice", default="",
                   help="t1,t2 seconds window to extract from the video")
    p.add_argument("-y", "--yes", action="store_true",
                   help="skip the images-folder replacement prompt")
    p.add_argument("--text", default=None, help="existing colmap text model dir")
    p.add_argument("--out", default="transforms.json")
    p.add_argument("--run_colmap", action="store_true")
    p.add_argument("--colmap_matcher", default="exhaustive")
    p.add_argument("--aabb_scale", type=int, default=16)
    p.add_argument("--skip_early", type=int, default=0)
    p.add_argument("--keep_colmap_coords", action="store_true")
    args = p.parse_args(argv)
    if args.video:
        run_ffmpeg(args.video, args.images, args.video_fps, args.time_slice,
                   yes=args.yes)
    text = args.text
    if args.run_colmap:
        text = run_colmap(args.images, os.path.dirname(args.out) or ".",
                          matcher=args.colmap_matcher)
    if text is None:
        p.error("provide --text or --run_colmap")
    convert(text, args.images, args.out, args.aabb_scale, args.skip_early,
            args.keep_colmap_coords)


if __name__ == "__main__":
    main(sys.argv[1:])
