"""nerfnav_tpu_torch's torch-ngp checkpoint converters vs the JAX package's,
and the train CLI with a background network, on the CPU.

A synthetic torch-ngp state dict (built as tests/test_torch_import.py
builds one, plus a background grid and net and a Morton-indexed density
grid) goes through both packages' import_torch_ckpt.main: the npz files
hold equal arrays. Exporting back gives the state dict exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

from nerfnav_tpu.data.synthetic import make_synthetic_scene
from nerfnav_tpu.scripts import export_torch_ckpt as jexport
from nerfnav_tpu.scripts import import_torch_ckpt as jimport
from nerfnav_tpu_torch.cli import main_nerf
from nerfnav_tpu_torch.models.network import NetworkConfig
from nerfnav_tpu_torch.models.occupancy import OccupancyConfig
from nerfnav_tpu_torch.models.renderer import RenderConfig
from nerfnav_tpu_torch.ops.marching import MarchConfig
from nerfnav_tpu_torch.scripts import export_torch_ckpt as texport
from nerfnav_tpu_torch.scripts import import_torch_ckpt as timport
from nerfnav_tpu_torch.training.trainer import Trainer, TrainerOptions
from test_torch_import import make_ref_state_dict

torch.set_num_threads(1)

GRID = 32
IMPORT_FLAGS = ["--bound", "1.0", "--log2_hashmap_size", "12", "--grid_size", str(GRID),
                "--desired_resolution", "256"]


def _bg_state_dict(seed=3, bg=True):
    """A torch-ngp state dict: field, density grid and (bg) the background's
    2-D grid over 4 levels x 2 features and its 24-64-3 net."""
    rng = np.random.default_rng(seed)
    sd, _, _ = make_ref_state_dict(rng, with_grid=True, grid_size=GRID)
    if bg:
        sizes = NetworkConfig(bg_radius=1.0).bg_grid.level_sizes
        sd["encoder_bg.embeddings"] = rng.normal(size=(sum(sizes), 2)).astype(np.float32)
        sd["encoder_bg.offsets"] = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        for i, (a, b) in enumerate([(24, 64), (64, 3)]):
            sd[f"bg_net.{i}.weight"] = rng.normal(size=(b, a)).astype(np.float32) * 0.1
    return sd


def _save_pth(sd, path, **extras):
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, **extras}, path)


def _npz(path):
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())["meta"]
        return {k: data[k] for k in data.files if k != "__meta__"}, meta


@pytest.mark.parametrize("bg", [True, False], ids=["bg", "no_bg"])
def test_import_matches_jax_and_export_round_trips(tmp_path, bg):
    """Both importers write the same arrays (dtype and value) and meta; the
    port's export of its npz gives the torch-ngp state dict back exactly,
    and equals the JAX package's export of the JAX npz."""
    sd = _bg_state_dict(bg=bg)
    pth = str(tmp_path / "ref.pth")
    _save_pth(sd, pth, epoch=7, global_step=7000, mean_density=3.25)
    out_j, out_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jimport.main([pth, "--out", out_j, *IMPORT_FLAGS])
    timport.main([pth, "--out", out_t, *IMPORT_FLAGS, "--device", "cpu"])
    (aj, mj), (at, mt) = _npz(out_j), _npz(out_t)
    assert mt == mj and mt["grid"]["coord_convention"] == "ngp"
    assert sorted(at) == sorted(aj)
    assert any("['bg_net']" in k for k in at) == bg
    for k in aj:
        assert at[k].dtype == aj[k].dtype, k
        np.testing.assert_array_equal(at[k], aj[k], err_msg=k)
    assert float(at["k:['occupancy']['mean_density']"]) == 3.25
    back_t, back_j = str(tmp_path / "t.pth"), str(tmp_path / "j.pth")
    texport.main([out_t, "--out", back_t, "--grid_size", str(GRID)])
    jexport.main([out_j, "--out", back_j, "--grid_size", str(GRID)])
    st = torch.load(back_t, weights_only=False)
    sj = torch.load(back_j, weights_only=False)
    assert sorted(st["model"]) == sorted(sd) == sorted(sj["model"])
    assert (st["epoch"], st["global_step"]) == (7, 7000)
    for k, v in sd.items():
        got = st["model"][k].numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
        np.testing.assert_array_equal(got, sj["model"][k].numpy(), err_msg=k)


def test_imported_bg_model_renders(tmp_path):
    """The imported npz resumes in the port's Trainer at the scene's
    bg_radius (the importer's config holds a placeholder radius) and renders
    a finite frame whose empty corners show the background network."""
    sd = _bg_state_dict(seed=4)
    pth = str(tmp_path / "ref.pth")
    _save_pth(sd, pth)
    out = str(tmp_path / "ckpts" / "ngp_ep0001.npz")
    timport.main([pth, "--out", out, *IMPORT_FLAGS, "--device", "cpu"])
    cfg = NetworkConfig(bound=1.0, grid_levels=6, grid_level_dim=2, grid_log2_hashmap_size=12,
                        grid_layout="corner", grid_coord_convention="ngp",
                        grid_max_resolution=256, bg_radius=4.0)
    tr = Trainer(cfg, RenderConfig(num_steps=24, upsample_steps=0, min_near=0.05,
                                   max_ray_batch=512),
                 TrainerOptions(name="imp", workspace=str(tmp_path / "ws"),
                                use_checkpoint=out, num_rays=64),
                 occupancy_cfg=OccupancyConfig(bound=1.0, grid_size=GRID),
                 march_cfg=MarchConfig(bound=1.0, grid_size=GRID, max_steps=64,
                                       samples_per_ray=8, min_near=0.05), device="cpu")
    tr._maybe_resume()
    emb = sd["encoder_bg.embeddings"]
    np.testing.assert_array_equal(tr.state.ema_params["bg_encoder"][0].numpy(), emb[:296])
    np.testing.assert_array_equal(tr.state.ema_params["bg_net"][1].numpy(),
                                  sd["bg_net.1.weight"].T)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -1.5
    img, _ = tr.render_full(tr.state.ema_params, pose,
                            np.asarray([32.0, 32.0, 16.0, 16.0]), 32, 32)
    assert torch.isfinite(img).all()
    black = tr.render_full(tr.state.ema_params, pose, np.asarray([32.0, 32.0, 16.0, 16.0]),
                           32, 32, bg_color=0.0)[0]
    assert torch.equal(img, black)  # the bg net, not bg_color, fills the rest
    assert float(img.min()) < 0.99


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bg_scene")
    make_synthetic_scene(str(d), n_train=3, n_val=1, H=32, W=32, num_steps=48)
    return str(d)


SMALL = ["--scale", "1.0", "--bound", "1.0", "--iters", "100", "--num_rays", "64",
         "--num_steps", "24", "--min_near", "0.05", "--max_ray_batch", "512",
         "--grid_levels", "4", "--grid_hashmap_log2", "12", "--grid_max_resolution", "64",
         "--grid_size", "32", "--max_steps", "256", "--samples_per_ray", "16",
         "--coarse_segments", "8", "--update_extra_interval", "32", "--device", "cpu"]


def test_main_bg_radius_train_then_test(scene_dir, tmp_path):
    """main_nerf trains 100 steps of the grid path (--cuda_ray --ff) with
    --bg_radius 8 and evaluates; --test resumes the checkpoint (bg_encoder
    and bg_net included), evaluates to the same PSNR and writes the frames
    under results/."""
    ws = str(tmp_path / "ws")
    args = [scene_dir, *SMALL, "--cuda_ray", "--ff", "--bg_radius", "8", "--workspace", ws]
    tr = main_nerf.main(args)
    assert tr.global_step == 100 and tr.cfg.bg_radius == 8.0
    assert {"bg_encoder", "bg_net"} <= set(tr.params)
    assert np.isfinite(tr.stats["loss"][0])
    psnr = tr.stats["results"][-1]
    tt = main_nerf.main(args + ["--test"])
    assert tt.global_step == 100
    for a, b in zip(tt.state.ema_params["bg_net"], tr.state.ema_params["bg_net"]):
        assert torch.equal(a, b)
    assert tt.stats["results"][-1] == pytest.approx(psnr, abs=1e-5)
    assert {"ngp_0000.png", "ngp_0000_depth.png"} <= set(os.listdir(os.path.join(ws,
                                                                               "results")))
