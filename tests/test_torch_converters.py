"""nerfnav_tpu_torch's dataset converters (scripts/colmap2nerf, llff2nerf,
hyper2nerf, tanks2nerf) against the JAX package's, on inputs the test
writes: the transforms.json each writes is equal, key for key and value for
value; the commands run_colmap and run_ffmpeg hand to subprocess.run are
equal; a converted COLMAP scene loads through the port's provider; and an
image the sharpness score cannot read raises in the port (the JAX package
scores it 100.0, which no test here pins).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfnav_tpu.scripts import colmap2nerf as jcolmap
from nerfnav_tpu.scripts import hyper2nerf as jhyper
from nerfnav_tpu.scripts import llff2nerf as jllff
from nerfnav_tpu.scripts import tanks2nerf as jtanks
from nerfnav_tpu_torch.data.provider import DatasetOptions, NeRFDataset
from nerfnav_tpu_torch.scripts import colmap2nerf as tcolmap
from nerfnav_tpu_torch.scripts import hyper2nerf as thyper
from nerfnav_tpu_torch.scripts import llff2nerf as tllff
from nerfnav_tpu_torch.scripts import tanks2nerf as ttanks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CAMERAS = {"SIMPLE_PINHOLE": "40.5 16.25 11.75",
           "PINHOLE": "40.5 38.25 16.5 12.0",
           "OPENCV": "40.5 39.0 16.25 12.25 0.01 -0.002 0.0005 -0.0003"}


def _load(path):
    with open(path) as f:
        return json.load(f)


def _write_images(d, names, hw=(24, 32), seed=0):
    import cv2

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, name in enumerate(names):
        img = (rng.random((*hw, 3)) * (60 + 60 * i)).astype(np.uint8)
        img[4 + i : 10 + i, 6:20] = 250  # a sharp edge whose strength differs per image
        assert cv2.imwrite(os.path.join(d, name), img)


def _qvec(rng):
    q = rng.normal(size=4)
    q[0] = abs(q[0]) + 2.0  # small rotations
    return q / np.linalg.norm(q)


def _colmap_model(root, model, n=5, seed=0):
    """A COLMAP text model of n cameras on a ring looking inward, and its
    images; returns (text_dir, images_dir)."""
    rng = np.random.default_rng(seed)
    text = os.path.join(root, "colmap_text")
    images = os.path.join(root, "images")
    os.makedirs(text, exist_ok=True)
    names = [f"frame_{i:03d}.png" for i in range(n)]
    _write_images(images, names, seed=seed)
    with open(os.path.join(text, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write(f"1 {model} 32 24 {CAMERAS[model]}\n")
    with open(os.path.join(text, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        for i, name in enumerate(names):
            q = _qvec(rng)
            t = rng.normal(size=3) * 0.5 + [0.0, 0.0, 3.0]
            f.write(f"{i + 1} {' '.join(map(repr, q.tolist()))} "
                    f"{' '.join(map(repr, t.tolist()))} 1 {name}\n")
            f.write(f"{rng.random() * 30:.3f} {rng.random() * 20:.3f} -1\n")
    return text, images


@pytest.mark.parametrize("model", list(CAMERAS))
def test_colmap2nerf_matches(tmp_path, model):
    """A text model per camera model, converted by both packages as
    recentred / rescaled scenes and with --keep_colmap_coords and
    --skip_early: the transforms.json files are equal (the sharpness
    scores included)."""
    text, images = _colmap_model(str(tmp_path), model)
    for kw in ({}, {"keep_colmap_coords": True}, {"skip_early": 2, "aabb_scale": 4}):
        outs = [str(tmp_path / f"{p}.json") for p in ("j", "t")]
        jcolmap.convert(text, images, outs[0], **kw)
        tcolmap.convert(text, images, outs[1], **kw)
        want, got = _load(outs[0]), _load(outs[1])
        assert got == want
        assert len(got["frames"]) == 5 - kw.get("skip_early", 0)
        sharp = [f["sharpness"] for f in got["frames"]]
        assert len(set(sharp)) == len(sharp) and 100.0 not in sharp
    if model == "OPENCV":
        assert (got["k1"], got["p2"]) == (0.01, -0.0003)


def test_colmap2nerf_cli_and_provider(tmp_path):
    """main --text into the scene's transforms.json, run as
    `python -m nerfnav_tpu_torch.scripts.colmap2nerf`: equal to the JAX
    main's file, and the scene loads through the port's provider (the
    first frame the val split, the rest train)."""
    text, images = _colmap_model(str(tmp_path), "PINHOLE", n=4)
    jcolmap.main(["--images", images, "--text", text, "--out", str(tmp_path / "j.json")])
    subprocess.run([sys.executable, "-m", "nerfnav_tpu_torch.scripts.colmap2nerf", "--images",
                    images, "--text", text, "--out", str(tmp_path / "transforms.json")],
                   check=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert _load(tmp_path / "transforms.json") == _load(tmp_path / "j.json")
    train = NeRFDataset(DatasetOptions(path=str(tmp_path), scale=0.33), "train")
    val = NeRFDataset(DatasetOptions(path=str(tmp_path), scale=0.33), "val")
    assert (len(train), len(val)) == (3, 1) and train.mode == "colmap"
    assert train.images.shape == (3, 24, 32, 3) and (train.H, train.W) == (24, 32)
    np.testing.assert_allclose(train.intrinsics, [40.5, 38.25, 16.5, 12.0])
    assert np.isfinite(train.poses).all()


def test_run_colmap_and_ffmpeg_commands(tmp_path, monkeypatch):
    """The commands of the COLMAP pipeline (both matchers, another binary)
    and of the frame extraction (with and without a time window) as both
    packages hand them to subprocess.run."""
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda argv, **k: calls.append((argv, k)))
    texts = []
    for mod, out in ((jcolmap, "j"), (tcolmap, "t")):
        texts.append(mod.run_colmap(str(tmp_path / "imgs"), str(tmp_path / out)))
        mod.run_colmap(str(tmp_path / "imgs"), str(tmp_path / out), colmap_cmd="bin/colmap",
                       matcher="sequential")
        mod.run_ffmpeg("v.mp4", str(tmp_path / out / "frames"), fps=2.5, yes=True)
        mod.run_ffmpeg("v.mp4", str(tmp_path / out / "frames"), fps=0, time_slice="1.5,4",
                       yes=True)
    half = len(calls) // 2
    assert half == 10
    strip = lambda argv, out: [a.replace(str(tmp_path / out), "<out>") for a in argv]  # noqa: E731
    for (aj, kj), (at, kt) in zip(calls[:half], calls[half:]):
        assert strip(at, "t") == strip(aj, "j") and kt == kj == {"check": True}
    assert calls[half + 1][0][1] == "exhaustive_matcher"
    assert calls[-1][0][:2] == ["ffmpeg", "-i"] and "between(t" in calls[-1][0][8]
    assert texts[1] == str(tmp_path / "t" / "colmap_text") and os.path.isdir(tmp_path / "t" / "sparse")


def test_sharpness_raises_on_an_unreadable_image(tmp_path):
    """The port's sharpness scores a readable image as the JAX package does
    and raises on one it cannot read, missing or corrupt, so convert does."""
    _write_images(str(tmp_path), ["a.png"])
    path = str(tmp_path / "a.png")
    assert tcolmap.sharpness(path) == jcolmap.sharpness(path) > 0
    (tmp_path / "bad.png").write_bytes(b"not a png")
    for bad in ("bad.png", "missing.png"):
        with pytest.raises(FileNotFoundError, match="cannot read"):
            tcolmap.sharpness(str(tmp_path / bad))
    text, images = _colmap_model(str(tmp_path / "scene"), "PINHOLE", n=3)
    os.remove(os.path.join(images, "frame_001.png"))
    with pytest.raises(FileNotFoundError, match="frame_001"):
        tcolmap.convert(text, images, str(tmp_path / "out.json"))


def test_llff2nerf_matches(tmp_path):
    """poses_bounds.npy of 4 views, at downscale 1 and 2: equal files; a
    count mismatch between images and poses fails in both."""
    rng = np.random.default_rng(1)
    n = 4
    poses = np.zeros((n, 3, 5))
    for i in range(n):
        poses[i, :, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        poses[i, :, 3] = rng.normal(size=3)
        poses[i, :, 4] = [378.0, 504.0, 407.5]
    pb = np.concatenate([poses.reshape(n, 15), rng.random((n, 2)) + [1.0, 5.0]], 1)
    np.save(tmp_path / "poses_bounds.npy", pb)
    os.makedirs(tmp_path / "images")
    for name in ("IMG_3.JPG", "IMG_1.jpg", "img_2.png", "img_0.jpeg", "notes.txt"):
        (tmp_path / "images" / name).write_bytes(b"")
    for ds in (1, 2):
        jllff.convert(str(tmp_path), downscale=ds, out_name="j.json")
        tllff.main([str(tmp_path), "--downscale", str(ds)])
        got, want = _load(tmp_path / "transforms.json"), _load(tmp_path / "j.json")
        assert got == want and got["w"] == 504 // ds and len(got["frames"]) == n
    (tmp_path / "images" / "extra.png").write_bytes(b"")
    for mod in (jllff, tllff):
        with pytest.raises(AssertionError, match="5 images vs 4 poses"):
            mod.convert(str(tmp_path))


def test_hyper2nerf_matches(tmp_path):
    """A HyperNeRF scene of 5 ids, one without a camera file: equal files,
    with the frames' time values."""
    rng = np.random.default_rng(2)
    ids = [f"{i:06d}" for i in range(5)]
    (tmp_path / "dataset.json").write_text(json.dumps({"ids": ids, "train_ids": ids[:4]}))
    (tmp_path / "scene.json").write_text(json.dumps({"center": [0.1, -0.2, 0.3],
                                                     "scale": 0.25}))
    os.makedirs(tmp_path / "camera")
    for fid in ids[:2] + ids[3:]:
        (tmp_path / "camera" / f"{fid}.json").write_text(json.dumps({
            "orientation": np.linalg.qr(rng.normal(size=(3, 3)))[0].tolist(),
            "position": rng.normal(size=3).tolist(), "focal_length": 1100.5,
            "principal_point": [540.25, 960.75]}))
    for ds in (2, 4):
        jhyper.convert(str(tmp_path), downscale=ds, out_name="j.json")
        thyper.main([str(tmp_path), "--downscale", str(ds)])
        got, want = _load(tmp_path / "transforms.json"), _load(tmp_path / "j.json")
        assert got == want and len(got["frames"]) == 4
        assert got["frames"][2]["time"] == 0.75 and got["fl_x"] == 1100.5 / ds


def test_tanks2nerf_matches(tmp_path):
    """A Tanks and Temples scene of 4 views (with a file that is no image):
    equal files, every camera within distance 1 of the centre."""
    rng = np.random.default_rng(3)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 1161.5, 1162.0, 959.5, 539.25
    np.savetxt(tmp_path / "intrinsics.txt", K)
    os.makedirs(tmp_path / "pose")
    os.makedirs(tmp_path / "rgb")
    for i in range(4):
        pose = np.eye(4)
        pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        pose[:3, 3] = rng.normal(size=3) * 3
        np.savetxt(tmp_path / "pose" / f"{i:06d}.txt", pose)
        (tmp_path / "rgb" / f"{i:06d}.png").write_bytes(b"")
    (tmp_path / "rgb" / "readme.md").write_bytes(b"")
    jtanks.convert(str(tmp_path), out_name="j.json")
    ttanks.main([str(tmp_path)])
    got, want = _load(tmp_path / "transforms.json"), _load(tmp_path / "j.json")
    assert got == want and len(got["frames"]) == 4 and got["cy"] == 539.25
    dist = [np.linalg.norm(np.asarray(f["transform_matrix"])[:3, 3]) for f in got["frames"]]
    assert max(dist) == pytest.approx(1.0)
