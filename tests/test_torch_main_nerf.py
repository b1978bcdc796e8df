"""nerfnav_tpu_torch's train CLI vs the JAX package's, on the CPU: the flags
resolve to the same configs, and `main` trains and then renders with
`--test` in the three configurations a user runs (`--cuda_ray --ff`: the grid
path at dt_gamma 1/128; `--ff`: the dense path; `-O --ff`: the flagship
grid), at 32x32 with `--device cpu`.
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from nerfnav_tpu.cli import flags as jflags
from nerfnav_tpu.data.synthetic import make_synthetic_scene
from nerfnav_tpu_torch.cli import flags as tflags
from nerfnav_tpu_torch.cli import main_nerf

torch.set_num_threads(1)

FLAG_SETS = {"O": ["-O"], "none": [], "cuda_ray": ["--cuda_ray"],
             "cuda_ray_dt0": ["--cuda_ray", "--dt_gamma", "0", "--bound", "1.5"],
             "O_grid": ["-O", "--grid_levels", "8", "--grid_layout", "corner", "--ff"]}


def _resolve(parser_mod, argv):
    opt = parser_mod.build_parser("t").parse_args(["scene", *argv])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfgs = parser_mod.make_configs(opt, for_nav=False)
    return opt, cfgs, [str(w.message) for w in caught if "dt_gamma" in str(w.message)]


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_make_configs_match(name):
    """The parsed and expanded flags (every flag both parsers have) and every
    field of the four configs equal the JAX package's, but for the port's
    one field of its own, the hash-grid kernel for training, and its own
    flags (--device, --mipnerf); the dt_gamma warning fires in both exactly
    when the grid path runs a gamma ladder."""
    opt_j, cfgs_j, warn_j = _resolve(jflags, FLAG_SETS[name])
    opt_t, cfgs_t, warn_t = _resolve(tflags, FLAG_SETS[name])
    vj, vt = vars(opt_j), vars(opt_t)
    own_flags = {"device", "mipnerf"}
    assert set(vt) - set(vj) == own_flags and not vt["mipnerf"]
    assert {k: vj[k] for k in vt if k not in own_flags} == {
        k: v for k, v in vt.items() if k not in own_flags}
    for cj, ct in zip(cfgs_j, cfgs_t):
        assert (cj is None) == (ct is None)
        if ct is not None:
            dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
            own = set(dt) - set(dj)
            assert own == ({"grid_backend"} if type(ct).__name__ == "NetworkConfig"
                           else set()), own
            assert {k: dj[k] for k in dt if k not in own} == {
                k: v for k, v in dt.items() if k not in own}, type(ct).__name__
    assert cfgs_t[0].grid_backend == "fused"
    assert bool(warn_t) == bool(warn_j) == (name in ("cuda_ray",))
    if name == "none":
        assert cfgs_t[3] is None and opt_t.dt_gamma == 1 / 128
        assert (cfgs_t[0].grid_levels, cfgs_t[0].grid_layout) == (16, "corner")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("main_nerf_scene")
    make_synthetic_scene(str(d), n_train=3, n_val=1, H=32, W=32, num_steps=48)
    return str(d)


SMALL = ["--scale", "1.0", "--bound", "1.0", "--iters", "100", "--num_rays", "64",
         "--num_steps", "24", "--min_near", "0.05", "--max_ray_batch", "512",
         "--grid_levels", "4", "--grid_hashmap_log2", "12", "--grid_max_resolution", "64",
         "--grid_size", "32", "--max_steps", "256", "--samples_per_ray", "16",
         "--coarse_segments", "8", "--update_extra_interval", "32", "--device", "cpu"]


@pytest.mark.parametrize("mode", [["--cuda_ray", "--ff"], ["--ff"], ["-O", "--ff"]],
                         ids=["grid-gamma", "dense", "O"])
def test_main_train_then_test(scene_dir, tmp_path, mode):
    """main trains 100 steps (one epoch) and evaluates; --test resumes the
    checkpoint, evaluates again to the same PSNR and writes the frames, the
    depth maps and the video (or logs why it could not) under results/."""
    ws = str(tmp_path / "ws")
    args = [scene_dir, *SMALL, *mode, "--workspace", ws]
    tr = main_nerf.main(args)
    assert tr.global_step == 100 and tr.epoch == 1
    assert (tr.march_cfg is None) == (mode == ["--ff"])
    if mode[0] == "--cuda_ray":
        assert tr.march_cfg.dt_gamma == 1 / 128 and isinstance(tr._ladder_plan[1], float)
    assert tr.cfg.mlp_backend == "fused" and np.isfinite(tr.stats["loss"][0])
    psnr = tr.stats["results"][-1]
    assert os.listdir(os.path.join(ws, "validation"))
    tt = main_nerf.main(args + ["--test"])
    assert tt.global_step == 100
    assert tt.stats["results"][-1] == pytest.approx(psnr, abs=1e-5)
    out = sorted(os.listdir(os.path.join(ws, "results")))
    assert {"ngp_0000.png", "ngp_0000_depth.png"} <= set(out)
    with open(os.path.join(ws, "log_ngp.txt")) as f:
        assert "ngp.mp4" in out or "no mp4 writer opened" in f.read()


@pytest.mark.parametrize("flag", [["--gui"], ["--rand_pose", "0"],
                                  ["--clip_weights", "w.pt", "--clip_text_embed", "t.npy"]],
                         ids=["gui", "rand_pose", "clip"])
def test_main_unported_flags_raise(flag, scene_dir, tmp_path, monkeypatch):
    """Flags that once raised as unported now run. --gui builds the viewer
    on the Trainer and the train split and serves it on port 7860 (serve
    stubbed), at the --W / --H / --radius / --fovy / --max_spp given and at
    their defaults, without training first. The CLIP flags: --rand_pose 0
    without a tower raises the Trainer's RuntimeError, half of the
    --clip_weights / --clip_text_embed pair exits, and with a tiny tower
    (.npz of seeded arrays) main trains its 100 steps, poseless ones at
    --rand_pose 0, supervised ones with the tower loaded."""
    if flag == ["--gui"]:
        from nerfnav_tpu_torch.gui import NeRFGUI

        served = []
        monkeypatch.setattr(NeRFGUI, "serve", lambda self, host="127.0.0.1", port=7860,
                            steps=None: served.append((self, host, port, steps)))
        base = [scene_dir, *SMALL, "-O", "--ff", "--workspace", str(tmp_path / "ws"), *flag]
        for extra, want in (([], (1920, 1080, 5.0, 50.0, 64)),
                            (["--W", "64", "--H", "48", "--radius", "3", "--fovy", "40",
                              "--max_spp", "8"], (64, 48, 3.0, 40.0, 8))):
            tr = main_nerf.main(base + extra)
            gui, host, port, steps = served[-1]
            cam = gui.cam
            assert (cam.W, cam.H, cam.radius, cam.fovy, gui.max_spp) == want
            assert (host, port, steps) == ("127.0.0.1", 7860, None)
            assert gui.trainer is tr and gui.training and gui.train_ds.split == "train"
            assert tr.global_step == 0 and tr.device.type == "cpu"
        return
    from test_torch_clip import write_clip_npz

    weights = write_clip_npz(str(tmp_path / "clip_tiny.npz"))
    np.save(tmp_path / "text.npy", np.random.default_rng(0).normal(size=16).astype(np.float32))
    ws = str(tmp_path / "ws")
    base = [scene_dir, *SMALL, "-O", "--ff", "--workspace", ws]
    with pytest.raises(SystemExit, match="come as a pair"):
        main_nerf.main(base + ["--clip_weights", weights])
    pair = ["--clip_weights", weights, "--clip_text_embed", str(tmp_path / "text.npy")]
    if flag[0] == "--rand_pose":
        with pytest.raises(RuntimeError, match="clip_loss_fn"):
            main_nerf.main(base + flag)
        from nerfnav_tpu_torch.training.trainer import Trainer

        calls, step = [], Trainer.clip_step
        monkeypatch.setattr(Trainer, "clip_step",
                            lambda self, *a, **k: calls.append(1) or step(self, *a, **k))
        tr = main_nerf.main(base + flag + pair)
        assert len(calls) == 100 and tr.opt.rand_pose == 0
    else:
        tr = main_nerf.main(base + pair)
        assert tr.opt.rand_pose == -1
    assert tr.clip_loss_fn.tower.cfg["image_size"] == 32
    assert tr.global_step == 100 and np.isfinite(tr.stats["loss"][0])
