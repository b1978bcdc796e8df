"""nerfnav_tpu_torch simulate CLI and nav flags against the JAX package's,
on the CPU: the parsers' defaults, make_configs' nav rules, a trainer
checkpoint loaded into the port's Field (densities within 1e-6 of the
params it was written from), and a whole mission of `main --analytic` at a
tiny size.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nerfnav_tpu.cli import flags as jflags
from nerfnav_tpu.cli import simulate as jsim
from nerfnav_tpu.models import network as jnet
from nerfnav_tpu_torch.cli import flags as tflags
from nerfnav_tpu_torch.cli import simulate as tsim
from nerfnav_tpu_torch.models.network import init_network
from nerfnav_tpu_torch.models.occupancy import OccupancyConfig, init_occupancy_state
from nerfnav_tpu_torch.models.renderer import make_field
from nerfnav_tpu_torch.training import checkpoint as ckpt_lib
from test_torch_march import shell_occupancy

torch.set_num_threads(1)


def test_sim_parser_defaults_match():
    pj = vars(jsim.build_sim_parser().parse_args(["scene"]))
    pt = vars(tsim.build_sim_parser().parse_args(["scene"]))
    assert pt.pop("device") == "cuda"
    assert pt == pj


@pytest.mark.parametrize("argv,for_nav", [(["-O"], True), (["-O", "--ff"], True),
                                          (["-O", "--ff"], False), (["--fp16"], True),
                                          ([], False)])
def test_make_configs_nav_rules(argv, for_nav):
    oj = jflags.build_parser("x").parse_args(["scene", *argv])
    ot = tflags.build_parser("x").parse_args(["scene", *argv])
    cj, rj, occj, mj = jflags.make_configs(oj, for_nav=for_nav)
    ct, rt, occt, mt = tflags.make_configs(ot, for_nav=for_nav)
    tfields = dataclasses.asdict(ct)
    for k, v in dataclasses.asdict(cj).items():
        if k in tfields:
            assert tfields[k] == v, k
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    assert ot.cuda_ray == oj.cuda_ray and ot.dt_gamma == oj.dt_gamma
    assert (occt is None) == (occj is None) and (mt is None) == (mj is None)
    if for_nav:
        assert ct.mlp_backend == "xla" and ct.grid_backward == "xla" and not ot.cuda_ray


def _small_opt(tmp_path, *extra):
    return tsim.build_sim_parser().parse_args([
        "scene", "--device", "cpu", "--workspace", str(tmp_path), "--grid_levels", "2",
        "--grid_level_dim", "8", "--grid_hashmap_log2", "10", "--grid_max_resolution", "32",
        "--grid_layout", "cell", "--bound", "1", "--grid_size", "32", "--obs_res", "24",
        "--obs_focal", "24", *extra])


def test_load_field_from_trainer_checkpoint(tmp_path):
    """A full checkpoint's EMA params and occupancy land in the Field and the
    frozen filter path; a model-only one gives params and no occupancy."""
    opt = _small_opt(tmp_path, "--filter_render", "frozen", "-O")
    cfg, _, _, _ = tflags.make_configs(opt, for_nav=True)
    ema = init_network(torch.Generator().manual_seed(4), cfg, device="cpu")
    occ = init_occupancy_state(OccupancyConfig(bound=1.0, grid_size=32), device="cpu")
    occ_np, _ = shell_occupancy(32, 1)
    occ.update({k: torch.as_tensor(v.astype(np.int64)) for k, v in occ_np.items()
                if k.startswith("blocks")})
    ckpt_lib.save_checkpoint(str(tmp_path / "checkpoints" / "ngp_ep0001"),
                             {"params": ema, "ema_params": ema, "occupancy": occ},
                             {"grid": ckpt_lib.grid_meta_of(cfg)})
    field, occupancy = tsim.load_field(opt, cfg, torch.device("cpu"))
    x = torch.rand((100, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    want = make_field(ema, cfg).density_fn(x)[0]
    np.testing.assert_allclose(field.density_fn(x)[0].detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=1e-6)
    assert occupancy is not None and torch.equal(occupancy["blocks"], occ["blocks"])
    closures = tsim.nav_closures(opt, field, occupancy, tflags.make_configs(opt, True)[1],
                                 torch.device("cpu"))
    march_fn = closures[4]
    o = torch.tensor([[0.0, -1.6, 0.0]] * 4)
    d = torch.nn.functional.normalize(torch.tensor([[0.0, 1.0, 0.0], [0.1, 1.0, 0.0],
                                                    [0.0, 1.0, 0.1], [0.2, 1.0, 0.1]]), dim=-1)
    assert march_fn(o, d)["valid"].any()
    ckpt_lib.save_checkpoint(str(tmp_path / "checkpoints" / "ngp_best"), ema,
                             {"grid": ckpt_lib.grid_meta_of(cfg)})
    opt.ckpt = "best"
    field, occupancy = tsim.load_field(opt, cfg, torch.device("cpu"))
    assert occupancy is None
    bad = dataclasses.replace(cfg, grid_levels=3)
    with pytest.raises(ValueError, match="grid architecture"):
        tsim.load_field(opt, bad, torch.device("cpu"))


def test_jax_checkpoint_loads(tmp_path):
    """The JAX package's network params written in its checkpoint format
    load through the same path."""
    from nerfnav_tpu.training import checkpoint as jckpt

    opt = _small_opt(tmp_path, "-O")
    cfg, _, _, _ = tflags.make_configs(opt, for_nav=True)
    jcfg = jnet.NetworkConfig(bound=1.0, grid_levels=2, grid_level_dim=8,
                              grid_log2_hashmap_size=10, grid_max_resolution=32,
                              grid_layout="cell", mlp_dtype="bfloat16")
    pj = jnet.init_network(jax.random.PRNGKey(2), jcfg)
    jckpt.save_checkpoint(str(tmp_path / "checkpoints" / "ngp_best.npz"), pj,
                          {"grid": ckpt_lib.grid_meta_of(cfg)})
    opt.ckpt = "best"
    field, _ = tsim.load_field(opt, cfg, torch.device("cpu"))
    from nerfnav_tpu.models import renderer as jrend

    x = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    want = np.asarray(jrend.make_field(pj, jcfg).density_fn(jax.numpy.asarray(x))[0])
    got = field.density_fn(torch.as_tensor(x))[0].numpy()
    # bf16 MLP: one rounding step of a hidden activation apart at most
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("fused", [True, False])
def test_main_analytic_mission(tmp_path, fused, monkeypatch):
    """`main --analytic` end to end: A*, the initial solve, three closed-loop
    ticks through the LM filter and one open-loop step; the estimates stay
    near the truth. The start faces the textured sphere, so the front end
    finds keypoints."""
    solves = []
    real = tsim.simulate

    def counted(traj, agent, filt, **kw):
        out = real(traj, agent, filt, **kw)
        solves.append(filt.last_losses)
        return out

    monkeypatch.setattr(tsim, "simulate", counted)
    argv = ["scene", "--analytic", "--device", "cpu", "--steps", "4", "--open_loop_steps",
            "1", "--obs_res", "48", "--obs_focal", "48", "--epochs_init", "10",
            "--epochs_update", "5", "--estimator_batch", "64", "--mpc_noise_std", "0",
            "--start", "-0.85", "0.0", "0.05", "--goal", "-0.6", "0.7", "0.0",
            "--poi_backend", "corners", "--poi_downscale", "1", "--workspace", str(tmp_path)]
    history = tsim.main(argv + ([] if fused else ["--no_fused"]))
    assert len(history) == 4 and solves[0] is not None
    assert np.isfinite(solves[0].numpy()).all()
    for true_s, est_s in history[:3]:
        assert np.isfinite(est_s).all()
        assert np.linalg.norm(true_s[0:3] - est_s[0:3]) < 0.05
    if not fused:
        assert (tmp_path / "estimator_data" / "step_0003.json").exists()
        assert any((tmp_path / "replan_poses" / "sim").iterdir())
