"""nerfnav_tpu_torch's dataset provider and synthetic scenes vs the JAX
package's, on the CPU.

Poses, intrinsics and host arrays must match exactly (the same numpy math
on the same inputs). Both packages decode the same PNG bytes, the port with
cv2 and the JAX package with imageio: the pixels must match exactly. The two
make_synthetic_scene renders differ by float32 rounding before the 8-bit
quantization, so their PNGs may differ by one code value (1/255) at a few
pixels.
"""

import json
import os

import numpy as np
import pytest
import torch

from nerfnav_tpu.data import provider as jprov
from nerfnav_tpu.data.synthetic import make_synthetic_scene as j_make_scene
from nerfnav_tpu_torch.data import provider as tprov
from nerfnav_tpu_torch.data.synthetic import make_synthetic_scene as t_make_scene

torch.set_num_threads(1)

HW = 24


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same blender-layout scene written by each package."""
    root = tmp_path_factory.mktemp("data_scenes")
    kw = dict(n_train=3, n_val=2, H=HW, W=HW, num_steps=32, seed=4)
    j_make_scene(str(root / "jax"), **kw)
    t_make_scene(str(root / "port"), device="cpu", **kw)
    return str(root / "jax"), str(root / "port")


def _datasets(path, split, **kw):
    return (jprov.NeRFDataset(jprov.DatasetOptions(path=path, **kw), split),
            tprov.NeRFDataset(tprov.DatasetOptions(path=path, **kw), split))


def _assert_same(dj, dt):
    assert (dj.mode, dj.H, dj.W, len(dj)) == (dt.mode, dt.H, dt.W, len(dt))
    np.testing.assert_array_equal(dt.poses, dj.poses)
    np.testing.assert_array_equal(dt.intrinsics, dj.intrinsics)
    if dj.images is None:
        assert dt.images is None
    else:
        assert dt.images.dtype == dj.images.dtype
        np.testing.assert_array_equal(dt.images, dj.images)


def test_pose_conversions_and_rand_poses():
    """Both conversions and their round trip, exactly; rand_poses from the
    same numpy seed, exactly."""
    rng = np.random.default_rng(0)
    for _ in range(4):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        pose[:3, 3] = rng.normal(size=3)
        scale, offset = float(rng.uniform(0.2, 2.0)), tuple(rng.normal(size=3))
        a = tprov.nerf_matrix_to_ngp(pose, scale, offset)
        np.testing.assert_array_equal(a, jprov.nerf_matrix_to_ngp(pose, scale, offset))
        b = tprov.ngp_to_nerf_matrix(a, scale, offset)
        np.testing.assert_array_equal(b, jprov.ngp_to_nerf_matrix(a, scale, offset))
        np.testing.assert_allclose(b, pose, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tprov.rand_poses(np.random.default_rng(3), 16, radius=2.5),
        jprov.rand_poses(np.random.default_rng(3), 16, radius=2.5))


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_reads_jax_scene(scenes, split):
    """The port's NeRFDataset on the JAX-written scene equals the JAX one:
    poses, intrinsics, RGBA pixels (cv2 vs imageio on the same PNGs)."""
    dj, dt = _datasets(scenes[0], split, scale=1.0)
    assert dt.mode == "blender" and dt.images.shape == (len(dt), HW, HW, 4)
    _assert_same(dj, dt)


def test_jax_reads_port_scene(scenes):
    """The JAX provider reads the port's scene as the port does, and the two
    packages' scenes agree: the same poses and focal, pixels within one
    8-bit code value at under 1% of the pixels."""
    for split in ("train", "val"):
        dj, dt = _datasets(scenes[1], split, scale=1.0)
        _assert_same(dj, dt)
        ref, _ = _datasets(scenes[0], split, scale=1.0)
        np.testing.assert_array_equal(dt.poses, ref.poses)
        np.testing.assert_array_equal(dt.intrinsics, ref.intrinsics)
        diff = np.abs(dt.images - ref.images)
        assert diff.max() <= 1.0 / 255 + 1e-7 and (diff > 0).mean() < 0.01
        assert dt.images[..., 3].max() == 1.0 and dt.images[..., 3].min() == 0.0


def test_as_arrays_fp16(scenes):
    """as_arrays equals the JAX arrays with and without fp16 (float16
    images: the targets the -O path trains on)."""
    for fp16 in (False, True):
        dj, dt = _datasets(scenes[0], "train", scale=1.0, fp16=fp16)
        aj, at = dj.as_arrays(), dt.as_arrays()
        for k in ("poses", "images", "intrinsics"):
            assert at[k].dtype == np.asarray(aj[k]).dtype, k
            np.testing.assert_array_equal(at[k], np.asarray(aj[k]))
    assert at["images"].dtype == np.float16


def _colmap_scene(src, dst):
    """A colmap-layout copy of a blender scene: one transforms.json with
    fl_x / fl_y / cx / cy, frames named out of order."""
    os.makedirs(dst, exist_ok=True)
    frames = []
    for split in ("train", "val"):
        with open(os.path.join(src, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        for fr in meta["frames"]:
            name = f"z{len(frames) % 3}_{fr['file_path']}"
            with open(os.path.join(src, fr["file_path"]), "rb") as f:
                data = f.read()
            with open(os.path.join(dst, name), "wb") as f:
                f.write(data)
            frames.append({"file_path": name, "transform_matrix": fr["transform_matrix"]})
    meta = {"fl_x": 30.0, "fl_y": 28.0, "cx": 11.0, "cy": 12.5, "w": HW, "h": HW,
            "frames": frames[::-1]}
    with open(os.path.join(dst, "transforms.json"), "w") as f:
        json.dump(meta, f)
    return dst


@pytest.mark.parametrize("kw", [dict(), dict(downscale=2, color_space="linear"),
                                dict(error_map=True, offset=(0.1, -0.2, 0.3))],
                         ids=["plain", "downscale-linear", "error_map-offset"])
def test_colmap_layout(scenes, tmp_path, kw):
    """A colmap scene: the sorted auto split, intrinsics from fl_x / cx with
    --downscale, the INTER_AREA resize, the linear color space, the error
    maps and the slerped test path, against the JAX provider."""
    root = _colmap_scene(scenes[0], str(tmp_path / "colmap"))
    for split in ("train", "val", "test"):
        dj, dt = _datasets(root, split, scale=0.8, **kw)
        assert dt.mode == "colmap"
        _assert_same(dj, dt)
        if dj.error_map is None:
            assert dt.error_map is None
        else:
            np.testing.assert_array_equal(dt.error_map, dj.error_map)
    assert len(dt) == 11 and dt.images is None  # n_test + 1 path poses
    assert dt.H == HW // kw.get("downscale", 1)


@pytest.mark.parametrize("name", ["linear_to_srgb", "srgb_to_linear"])
def test_srgb_curves_match_jax(name):
    """Both sRGB transfer curves (the second is what --color_space linear
    applies above) against the JAX package's within 1e-6: seeded values in
    and out of [0, 1], 0, 1 and both knees with their float32 neighbours."""
    from nerfnav_tpu.training import metrics as jmetrics
    from nerfnav_tpu_torch.training import metrics as tmetrics

    knees = np.float32([0.0031308, 0.04045])
    edges = np.concatenate([[0.0, 1.0, -0.25, 1.5], knees,
                            np.nextafter(knees, np.float32(0)),
                            np.nextafter(knees, np.float32(1))]).astype(np.float32)
    x = np.concatenate([edges, np.random.default_rng(11).uniform(
        -0.5, 1.5, 1000).astype(np.float32)])
    got = getattr(tmetrics, name)(x)
    want = getattr(jmetrics, name)(x)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # 0 and 1 are fixed points; values out of range clip to them
    np.testing.assert_allclose(got[:4], [0.0, 1.0, 0.0, 1.0], rtol=0, atol=1e-6)


def test_interpolate_test_path_and_dataloader(scenes):
    """_interpolate_test_path on the same frames (seeded draw, Slerp) within
    1e-6, and the dataloader's index sequence and poses, exactly."""
    with open(os.path.join(scenes[0], "transforms_train.json")) as f:
        frames = json.load(f)["frames"]
    for n_test, seed in ((10, 0), (7, 5)):
        pj = jprov.NeRFDataset._interpolate_test_path(frames, n_test, 0.5, (0.1, 0, 0), seed)
        pt = tprov.NeRFDataset._interpolate_test_path(frames, n_test, 0.5, (0.1, 0, 0), seed)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    dj, dt = _datasets(scenes[0], "train", scale=1.0)
    for a, b in zip(dj.dataloader(12, seed=2), dt.dataloader(12, seed=2)):
        assert a["index"] == b["index"]
        np.testing.assert_array_equal(b["pose"], a["pose"])
        np.testing.assert_array_equal(b["image"], a["image"])


def test_load_image_16bit_and_gray(tmp_path):
    """_load_image of 8- and 16-bit gray PNGs (written by the port) equals
    the JAX loader's. A 16-bit RGB PNG keeps its 16 bits (x / 65535): the
    JAX loader's imageio (Pillow backend) reduces one to 8 bits, so it is
    held against the written values instead."""
    rng = np.random.default_rng(1)
    for name, img in (("gray8.png", rng.integers(0, 256, (9, 7)).astype(np.uint8)),
                      ("gray16.png", rng.integers(0, 65536, (9, 7)).astype(np.uint16))):
        path = str(tmp_path / name)
        tprov.write_image(path, img)
        got = tprov._load_image(path)
        assert got.shape == (9, 7, 3)
        np.testing.assert_array_equal(got, jprov._load_image(path))
    rgb16 = rng.integers(0, 65536, (9, 7, 3)).astype(np.uint16)
    path = str(tmp_path / "rgb16.png")
    tprov.write_image(path, rgb16)
    np.testing.assert_array_equal(tprov._load_image(path),
                                  rgb16.astype(np.float32) / 65535.0)
