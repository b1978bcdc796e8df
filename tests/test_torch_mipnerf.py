"""mip-NeRF in nerfnav_tpu_torch against the benchmark's plain reference
(perfbench/reference/mipnerf.py, float32 torch that imports nothing of the
port) and against the closed forms, on the CPU at a small size: widths cut to
32, IPE degrees to 0..5, 8 + 8 samples, a few rays, seeded random weights.

The port's MLP is bf16 operands with float32 products, sums and results;
the reference at the configuration's precision rounds the same operands
and sums in float32 too, in another order. So the outputs agree to float32
rounding, but a sum a bit apart can round to the neighbouring bf16 value
where it becomes the next layer's operand: 2^-8 of that entry. The
tolerances below are a few such steps, and each says so."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from nerfnav_tpu_torch.cli import flags as tflags
from nerfnav_tpu_torch.data.rays import RayDraws, get_rays
from nerfnav_tpu_torch.models.network import MipNerfConfig, init_mipnerf, mipnerf_mlp
from nerfnav_tpu_torch.models.renderer import RenderConfig, render_rays_mip, resample_along_rays
from nerfnav_tpu_torch.ops.ipe import cast_cones, integrated_pos_enc, pos_enc
from nerfnav_tpu_torch.training.trainer import Trainer, TrainerOptions, _leaves
from perfbench.reference import mipnerf as ref

torch.set_num_threads(1)

CFG = MipNerfConfig(net_width=32, net_width_condition=32, max_deg_point=6, deg_view=2,
                    num_samples=8)
C = dataclasses.asdict(CFG)
HW = 16
INTR = [20.0, 20.0, 8.0, 8.0]


def _pose(angle=0.3, radius=4.03):
    c, s = math.cos(angle), math.sin(angle)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]   # looks along +z rotated about y
    pose[:3, 3] = -radius * pose[:3, 2]
    return torch.as_tensor(pose)


def _params(seed=0, bias_scale=0.05):
    """Glorot weights, and biases made nonzero so that they are tested."""
    p = init_mipnerf(torch.Generator().manual_seed(seed), CFG, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    return {k: [t if t.dim() == 2 else bias_scale * torch.randn(t.shape, generator=g)
                for t in v] for k, v in p.items()}


def _rays(n=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    inds = torch.randint(0, HW * HW, (n,), generator=g)
    inds[0] = HW * HW - 1      # a pixel of the last row
    return get_rays(_pose(), torch.tensor(INTR), HW, HW, RayDraws(inds=inds), cone=True)


# ---------------------------------------------------------------- rays
def test_cone_rays_match_the_reference_and_the_pixel_pitch():
    r = _rays()
    o, d, radii = ref.cone_rays(_pose(), torch.tensor(INTR), HW, HW, r["inds"])
    assert torch.equal(r["rays_o"], o) and torch.equal(r["rays_d"], d)
    assert torch.equal(r["radii"], radii)
    # directions at unit camera depth; neighbouring rows 1 / fy apart
    assert torch.allclose(r["rays_d"] @ _pose()[:3, 2], torch.ones(len(o)), atol=1e-6)
    assert torch.allclose(radii, torch.full_like(radii, 2 / math.sqrt(12) / 20.0), rtol=1e-5)


# ------------------------------------------------------- frustum and IPE
def _closed_forms(t0, t1, r, d):
    """mip-NeRF's frustum equations (mip.py, stable form) in float64."""
    mu, h = (t0 + t1) / 2, (t1 - t0) / 2
    t_mean = mu + 2 * mu * h**2 / (3 * mu**2 + h**2)
    t_var = h**2 / 3 - (4 / 15) * h**4 * (12 * mu**2 - h**2) / (3 * mu**2 + h**2) ** 2
    r_var = r**2 * (mu**2 / 4 + (5 / 12) * h**2 - (4 / 15) * h**4 / (3 * mu**2 + h**2))
    d2 = d**2
    cov = t_var[..., None] * d2[:, None] + r_var[..., None] * (1 - d2 / d2.sum(-1, keepdim=True))[:, None]
    return t_mean, cov


def test_frustum_gaussian_and_ipe_match_the_closed_forms():
    r = _rays()
    g = torch.Generator().manual_seed(3)
    t = torch.sort(2.0 + 4.0 * torch.rand((len(r["inds"]), 9), generator=g), -1).values
    means, covs = cast_cones(t, r["rays_o"], r["rays_d"], r["radii"])
    rm, rc = ref.cast(t, r["rays_o"], r["rays_d"], r["radii"])
    # the same float32 expressions, grouped alike
    assert torch.allclose(means, rm, rtol=1e-6, atol=1e-6)
    assert torch.allclose(covs, rc, rtol=1e-5, atol=1e-12)
    t_mean, cov = _closed_forms(t[:, :-1].double(), t[:, 1:].double(),
                                r["radii"].double(), r["rays_d"].double())
    want_means = r["rays_o"].double()[:, None] + r["rays_d"].double()[:, None] * t_mean[..., None]
    assert torch.allclose(means.double(), want_means, rtol=1e-6, atol=1e-6)
    # float32 cancels in t_var's two terms of size h^2: 1e-5 of h^2
    assert torch.allclose(covs.double(), cov, rtol=1e-3, atol=1e-10)
    x = integrated_pos_enc(means, covs, CFG.min_deg_point, CFG.max_deg_point)
    assert torch.equal(x, ref.ipe(means, covs, C))
    lv = torch.arange(CFG.min_deg_point, CFG.max_deg_point, dtype=torch.float64)
    y = (means.double()[..., None, :] * 2.0 ** lv[:, None]).flatten(-2)
    w = torch.exp(-0.5 * (covs.double()[..., None, :] * 4.0 ** lv[:, None]).flatten(-2))
    assert torch.allclose(x.double(), torch.cat([torch.sin(y) * w, torch.cos(y) * w], -1),
                          atol=2e-4)   # float32 sines of arguments up to 2^5 x 6


def test_ipe_at_zero_radius_is_plain_pe_weighted_by_the_depth_variance():
    r = _rays()
    t = ref.coarse_edges(len(r["inds"]), None, C, torch.device("cpu"))
    means, covs = cast_cones(t, r["rays_o"], r["rays_d"], torch.zeros_like(r["radii"]))
    t0, t1 = t[:, :-1].double(), t[:, 1:].double()
    mu, h = (t0 + t1) / 2, (t1 - t0) / 2
    t_var = h**2 / 3 - (4 / 15) * h**4 * (12 * mu**2 - h**2) / (3 * mu**2 + h**2) ** 2
    assert torch.allclose(covs.double(), t_var[..., None] * r["rays_d"].double()[:, None] ** 2,
                          rtol=1e-4, atol=1e-12)
    x = integrated_pos_enc(means, covs, CFG.min_deg_point, CFG.max_deg_point)
    plain = pos_enc(means, CFG.min_deg_point, CFG.max_deg_point)[..., 3:]
    lv = torch.arange(CFG.min_deg_point, CFG.max_deg_point, dtype=torch.float32)
    weight = torch.exp(-0.5 * (covs[..., None, :] * 4.0 ** lv[:, None]).flatten(-2))
    assert torch.allclose(x, plain * torch.cat([weight, weight], -1), atol=1e-6)


def test_view_encoding_matches_the_reference():
    d = _rays()["rays_d"]
    d = d / d.norm(dim=-1, keepdim=True)
    assert torch.equal(pos_enc(d, 0, CFG.deg_view), ref.pos_enc(d, CFG.deg_view))
    assert pos_enc(d, 0, 4).shape[-1] == 27


# ---------------------------------------------------------------- the MLP
def _mlp_inputs(n=12, t=8, seed=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, t, CFG.pos_dim), generator=g) * 2 - 1
    cond = torch.rand((n, CFG.dir_dim), generator=g) * 2 - 1
    return x, cond


def test_layer_widths_and_published_counts():
    dims = MipNerfConfig().layer_dims()
    assert dims["trunk"][0] == (96, 256) and dims["trunk"][5] == (352, 256)
    assert all(d == (256, 256) for i, d in enumerate(dims["trunk"][1:], 1) if i != 5)
    assert dims["sigma"] == [(256, 1)] and dims["view"] == [(283, 128)]
    macs = sum(a * b for v in dims.values() for a, b in v)
    assert 2 * macs == 1_220_608
    params = sum(a * b + b for v in dims.values() for a, b in v)
    assert params == 612_740


def _mlp_gaps(prec):
    """Max output gap and worst gradient gap (relative) of the port's MLP
    against the reference's at precision prec, for a random cotangent."""
    params = _params()
    x, cond = _mlp_inputs()
    p_leaves = [t.clone().requires_grad_() for t in _leaves(params)]
    r_leaves = [t.clone().requires_grad_() for t in _leaves(params)]
    rgb, dens = mipnerf_mlp(ref.with_leaves(params, p_leaves), x, cond, CFG)
    with ref.no_tf32():
        r_rgb, r_dens = ref.mlp(ref.with_leaves(params, r_leaves), x, cond, C, prec)
    gr, gd = torch.randn_like(rgb), torch.randn_like(dens)
    ((rgb * gr).sum() + (dens * gd).sum()).backward()
    ((r_rgb * gr).sum() + (r_dens * gd).sum()).backward()
    out = max(float((a - b).abs().max() / b.abs().max())
              for a, b in ((rgb.detach(), r_rgb.detach()), (dens.detach(), r_dens.detach())))
    grad = max(float((a.grad - b.grad).norm() / b.grad.norm()) for a, b in zip(p_leaves, r_leaves))
    return out, grad


# the same rounding on both sides; a sum one float32 ulp apart may round to
# the neighbouring bf16 operand: a few 2^-8 steps of single entries
MLP_TOL = 2e-3


def test_mlp_with_its_skip_and_heads_matches_the_reference():
    out, grad = _mlp_gaps("bfloat16")
    assert out < MLP_TOL and grad < 3 * MLP_TOL


def test_the_mlp_comparison_tells_a_lower_precision():
    """fp8 operands (the benchmark's control) miss the same tolerances."""
    out, grad = _mlp_gaps("fp8")
    assert out > MLP_TOL and grad > 3 * MLP_TOL


def test_mlp_fault_is_caught_by_the_comparison():
    """The comparison sees a dropped skip input: the tolerance is tight."""
    params = _params()
    x, cond = _mlp_inputs()
    rgb, dens = mipnerf_mlp(params, x, cond, CFG)
    broken = dict(C, skip_layer=100)
    with ref.no_tf32(), pytest.raises(RuntimeError):
        ref.mlp(params, x, cond, broken, "bfloat16")     # 352-wide weight, 256 input
    x2 = x.clone()
    x2[..., 0] += 0.5
    rgb2, _ = mipnerf_mlp(params, x2, cond, CFG)
    assert float((rgb2 - rgb).abs().max() / rgb.abs().max()) > 2e-3


# ----------------------------------------------------------- resampling
@pytest.mark.parametrize("stratified", [True, False])
def test_blurred_resample_matches_the_reference_sorted_and_inside(stratified):
    n, s = 32, CFG.num_samples
    g = torch.Generator().manual_seed(11)
    jitter = torch.rand((n, s + 1), generator=g) if stratified else None
    t = ref.coarse_edges(n, jitter, C, torch.device("cpu"))
    w = torch.rand((n, s), generator=g) ** 4
    w[0] = 0.0                              # a ray with no weight: the padding's
    w[1, 3] = 50.0                          # one interval holds nearly all
    u = torch.rand((n, s + 1), generator=g) if stratified else None
    got = resample_along_rays(t, w, u, CFG.resample_padding)
    want = ref.resample(t, w, u, C)
    # searchsorted against mipnerf's mask: the same intervals, the same sums
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    assert (got[:, 1:] >= got[:, :-1]).all()
    assert (got >= CFG.near).all() and (got <= CFG.far).all()
    # half of the blurred weight sits in the heavy interval and its two
    # neighbours: far more than their share of the new depths land there
    inside = ((got[1] >= t[1, 2]) & (got[1] <= t[1, 5])).sum()
    assert inside > (s + 1) // 2


# ------------------------------------------------------- the train step
class _Scene:
    """A tiny dataset: as_arrays(), H, W and len."""

    def __init__(self, n=2, seed=0):
        rng = np.random.default_rng(seed)
        self.H = self.W = HW
        self.poses = np.stack([_pose(0.3 + 0.4 * i).numpy() for i in range(n)])
        self.images = rng.random((n, HW, HW, 4), dtype=np.float32)
        self.intrinsics = np.asarray(INTR, np.float32)

    def as_arrays(self):
        return {"poses": self.poses, "images": self.images, "intrinsics": self.intrinsics}

    def __len__(self):
        return len(self.poses)


def _trainer(tmp_path, params=None):
    opt = TrainerOptions(name="mip", workspace=str(tmp_path), num_rays=32,
                         use_checkpoint="scratch", bg_train="white")
    return Trainer(CFG, RenderConfig(max_ray_batch=100), opt, params=params, device="cpu")


def test_one_train_step_matches_the_reference(tmp_path):
    params = _params()
    tr = _trainer(tmp_path, params)
    ds = _Scene()
    arrays = tr._device_arrays(ds)
    draws = tr.draw_step(tr.state, 1, HW, HW)
    leaves0 = [t.detach().clone() for t in _leaves(tr.state.params)]
    out = tr.loss_and_grads(tr.state, arrays, draws)
    tr.apply(tr.state, out, 1, HW, HW)
    o, d, radii = ref.cone_rays(arrays["poses"][1], arrays["intrinsics"], HW, HW,
                                draws.rays.inds)
    px = arrays["images"][1].reshape(HW * HW, 4)[draws.rays.inds]
    gt = px[:, :3] * px[:, 3:] + draws.bg * (1 - px[:, 3:])
    loss, grads, ts, _ = ref.loss_and_grads(ref.with_leaves(params, leaves0), o, d, radii,
                                            draws.jitter, draws.u, draws.bg, gt, C,
                                            "bfloat16", block=8)
    # bf16 neighbours of single operands (see the module's docstring); the
    # reference with fp8 operands misses these by 300x
    assert float(out.loss) == pytest.approx(loss, rel=1e-5)
    for a, b in zip(out.grads, grads):
        assert float((a - b).norm()) <= 1e-3 * float(b.norm()) + 1e-9, a.shape
    # Adam's first step at mipnerf's rate for step 1 (5.3e-6 here): each
    # parameter moves by lr x g / (|g| + 1e-8), so entries whose gradient
    # sits at rounding level may differ by up to 2 lr
    after = ref.adam(leaves0, [grads], C)
    lr1 = ref.lr(1, C)
    assert tr._lr(0) == pytest.approx(lr1, rel=1e-12)
    off = total = 0
    for a, b, p in zip([t.detach() for t in _leaves(tr.state.params)], after, leaves0):
        assert float((a - p).abs().max()) <= lr1 * 1.001
        off += int(((a - b).abs() > 0.1 * lr1).sum())
        total += a.numel()
    assert off <= 0.01 * total, (off, total)
    # the EMA params are the params (no EMA)
    assert tr.state.ema_params is tr.state.params


def test_learning_rate_is_mipnerfs_delayed_log_linear():
    cfg = MipNerfConfig()
    c = dataclasses.asdict(cfg)
    for step in (1, 100, 2500, 5000, 500_000, 1_000_000, 2_000_000):
        assert cfg.lr(step) == pytest.approx(ref.lr(step, c), rel=1e-12)
    assert cfg.lr(2500) == pytest.approx(5e-4 * math.exp(math.log(1e-2) * 2500 / 1e6))
    assert cfg.lr(1_000_000) == pytest.approx(5e-6)
    assert cfg.lr(1) == pytest.approx(5e-4 * (0.01 + 0.99 * math.sin(0.5 * math.pi / 2500)),
                                      rel=1e-3)


def test_make_configs_expands_the_flag():
    opt = tflags.build_parser("t").parse_args(["scene", "--mipnerf", "--max_ray_batch", "1024"])
    cfg, rcfg, occ, march = tflags.make_configs(opt)
    assert cfg == MipNerfConfig() and occ is None and march is None
    assert rcfg.max_ray_batch == 1024
    assert (cfg.net_depth, cfg.net_width, cfg.skip_layer, cfg.net_width_condition) == (
        8, 256, 4, 128)
    assert (cfg.num_samples, cfg.num_levels, cfg.near, cfg.far) == (128, 2, 2.0, 6.0)
    assert (cfg.adam_betas, cfg.adam_eps, cfg.coarse_loss_mult) == ((0.9, 0.999), 1e-8, 0.1)
    for bad in (["--cuda_ray"], ["-O"]):
        with pytest.raises(ValueError):
            tflags.make_configs(tflags.build_parser("t").parse_args(["scene", "--mipnerf", *bad]))
    with pytest.raises(ValueError):
        tflags.make_configs(tflags.build_parser("t").parse_args(["scene", "--mipnerf"]),
                            for_nav=True)


def test_evaluate_renders_a_16x16_frame(tmp_path):
    params = _params()
    tr = _trainer(tmp_path, params)
    ds = _Scene(n=1)
    psnr = tr.evaluate(ds)
    assert np.isfinite(psnr)
    image, depth = tr.render_full(tr.state.params, ds.poses[0], ds.intrinsics, HW, HW)
    assert image.shape == (HW, HW, 3) and depth.shape == (HW, HW)
    assert ((depth >= CFG.near) & (depth <= CFG.far)).all()
    # the reference's render at the evenly spaced depths, pixel by pixel
    inds = torch.arange(HW * HW)
    o, d, radii = ref.cone_rays(torch.as_tensor(ds.poses[0]), torch.tensor(INTR), HW, HW, inds)
    with ref.no_tf32():
        images, _, _ = ref.render(params, o, d, radii, None, None,
                                  torch.ones(()), C, "bfloat16")
    assert torch.allclose(image.reshape(-1, 3), images[-1], atol=5e-3)
    with pytest.raises(ValueError):
        tr.save_mesh()


def test_render_counts_and_levels():
    """Both levels shade num_samples a ray and return their depths; the
    fine depths carry no gradient."""
    params = {k: [t.requires_grad_() for t in v] for k, v in _params().items()}
    r = _rays(n=8)
    out = render_rays_mip(params, CFG, r["rays_o"], r["rays_d"], r["radii"],
                          jitter=torch.rand(8, 9), u=torch.rand(8, 9))
    assert [t.shape for t in out["t"]] == [(8, 9), (8, 9)]
    assert not out["t"][1].requires_grad
    assert len(out["level_images"]) == 2 and out["image"] is out["level_images"][-1]


def test_main_nerf_trains_and_tests_mipnerf(tmp_path, monkeypatch):
    """`main_nerf.main --mipnerf` trains one epoch through Trainer.train on
    white, evaluates through render_full, and `--test` resumes and renders
    the frames; the field at this file's small widths (monkeypatched into
    make_configs), the flag's expansion being tested above."""
    import functools
    import os

    from nerfnav_tpu_torch.cli import main_nerf
    from nerfnav_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfnav_tpu_torch.models import network

    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, n_train=2, n_val=1, H=16, W=16, num_steps=16, device="cpu")
    monkeypatch.setattr(network, "MipNerfConfig",
                        functools.partial(MipNerfConfig, **{k: C[k] for k in (
                            "net_width", "net_width_condition", "max_deg_point", "deg_view",
                            "num_samples")}))
    args = [scene, "--mipnerf", "--iters", "100", "--num_rays", "32", "--device", "cpu",
            "--workspace", str(tmp_path / "ws"), "--scale", "1.0"]
    tr = main_nerf.main(args)
    assert tr.cfg.cone_rays and tr.opt.bg_train == "white" and tr.global_step == 100
    assert np.isfinite(tr.stats["loss"][0]) and np.isfinite(tr.stats["results"][-1])
    tt = main_nerf.main(args + ["--test"])
    assert tt.global_step == 100
    assert tt.stats["results"][-1] == pytest.approx(tr.stats["results"][-1], abs=1e-5)
    assert "ngp_0000.png" in os.listdir(tmp_path / "ws" / "results")
