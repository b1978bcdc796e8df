"""nerfnav_tpu_torch pose filter, dense renderer and agent against the JAX
package, on the CPU, on numpy-seeded inputs.

Tolerances, relative to each array's largest entry unless stated:
- rays, render_rays (with and without upsampling, the draws injected),
  render_image and render_rays_frozen on float32 fields: 1e-5 absolute;
- the residual Jacobian (jacfwd here, jax.linearize + vmap there): 1e-4 on
  float32 fields; 3e-2 with a bfloat16 MLP, where the tangents are rounded
  at the same casts but a density can round to either side of a step;
- the GN/LM update from injected draws (x, posterior covariance, losses)
  and the Adam update: 1e-4, since twelve-tangent Jacobians and the
  eigen-decompositions amplify float32 rounding;
- interest masks: equal; the agent's uint8 observation: within 1 LSB.
The port's FusedMPC tick equals its own unfused sequence within
tests/test_nav_fused.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from nerfnav_tpu.data import rays as jrays
from nerfnav_tpu.data import synthetic as jsyn
from nerfnav_tpu.models import network as jnet
from nerfnav_tpu.models import renderer as jrend
from nerfnav_tpu.nav import agent as jagent
from nerfnav_tpu.nav import estimator as jest
from nerfnav_tpu.nav.dynamics import DynamicsConfig as JDyn
from nerfnav_tpu_torch.data import rays as trays
from nerfnav_tpu_torch.data import synthetic as tsyn
from nerfnav_tpu_torch.models import network as tnet
from nerfnav_tpu_torch.models import renderer as trend
from nerfnav_tpu_torch.nav import agent as tagent
from nerfnav_tpu_torch.nav import estimator as test_
from nerfnav_tpu_torch.nav.dynamics import DynamicsConfig as TDyn
from nerfnav_tpu_torch.nav.fused import FusedMPC
from nerfnav_tpu_torch.nav.planner import Planner, PlannerConfig
from nerfnav_tpu_torch.ops import marching as tm
from nerfnav_tpu_torch.training.checkpoint import occupancy_from_numpy, params_from_numpy
from test_torch_march import shell_occupancy

torch.set_num_threads(1)

H = W = 32
FOCAL = 32.0
INTR = np.asarray([FOCAL, FOCAL, W / 2, H / 2], np.float32)
NET_KW = dict(bound=1.0, grid_levels=2, grid_level_dim=8, grid_log2_hashmap_size=10,
              grid_max_resolution=32, grid_layout="cell", density_scale=10.0)
EST_KW = dict(lr=5e-3, n_iters=4, gn_iters=4, gn_jac_batch=32, batch_size=64, pool_size=256,
              sig0=1.0)
X0 = np.zeros(12, np.float32)
X0[0:3] = [0.0, -1.6, 0.0]
X0[6:9] = [0.0, 0.0, np.pi / 2]  # body +x (the camera's axis) toward the origin


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


def _fields(kind):
    if kind == "textured":
        return jsyn.textured_sphere_field(), tsyn.textured_sphere_field()
    kw = dict(NET_KW, mlp_dtype=kind)
    pj = jnet.init_network(jax.random.PRNGKey(5), jnet.NetworkConfig(**kw))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    return (jrend.make_field(pj, jnet.NetworkConfig(**kw)),
            trend.make_field(pt, tnet.NetworkConfig(**kw)))


def _estimators(kind="textured", steps=32, frozen=None, **kw):
    fj, ft = _fields(kind)
    rj = jrend.RenderConfig(num_steps=steps, upsample_steps=0, min_near=0.05)
    rt = trend.RenderConfig(num_steps=steps, upsample_steps=0, min_near=0.05)
    ij, it = jnp.asarray(INTR), torch.as_tensor(INTR)
    cfg = dict(EST_KW, **kw)
    extra_j, extra_t = {}, {}
    if frozen is not None:  # a fixed lattice for both: (z, dt, valid) numpy
        z, dt, valid = frozen
        extra_j = dict(march_fn=lambda o, d: {"z": jnp.asarray(z), "dt": jnp.asarray(dt),
                                              "valid": jnp.asarray(valid)},
                       render_frozen_fn=lambda o, d, *zdv: jrend.render_rays_frozen(
                           fj, fj.bound, o, d, *zdv, bg_color=1.0))
        extra_t = dict(march_fn=lambda o, d: {"z": torch.as_tensor(z), "dt": torch.as_tensor(
            dt), "valid": torch.as_tensor(valid)},
            render_frozen_fn=lambda o, d, *zdv: trend.render_rays_frozen(
                ft, ft.bound, o, d, *zdv, bg_color=1.0))
    ej = jest.Estimator(jest.EstimatorConfig(**cfg), JDyn(dt=0.2),
                        lambda o, d: jrend.render_rays(fj, rj, o, d, bg_color=1.0),
                        lambda p: jrays.get_all_rays(p, ij, H, W),
                        jagent.body_state_to_camera_pose,
                        get_rays_at_fn=lambda p, i: jrays.get_rays_at(p, ij, W, i), **extra_j)
    et = test_.Estimator(test_.EstimatorConfig(**cfg), TDyn(dt=0.2),
                         lambda o, d: trend.render_rays(ft, rt, o, d, bg_color=1.0),
                         lambda p: trays.get_all_rays(p, it, H, W),
                         tagent.body_state_to_camera_pose,
                         get_rays_at_fn=lambda p, i: trays.get_rays_at(p, it, W, i),
                         device="cpu", **extra_t)
    return ej, et, fj, ft


@pytest.fixture(scope="module")
def obs():
    """The observation at X0 of the textured sphere, rendered by the JAX agent."""
    cfg = jagent.AgentConfig(dyn=JDyn(dt=0.2), H=H, W=W, focal=FOCAL)
    agent = jagent.Agent(X0, cfg, field=jsyn.textured_sphere_field(), render_chunk=H * W)
    return agent.get_img(np.asarray(jagent.body_state_to_camera_pose(jnp.asarray(X0))))


def _perturbed():
    rng = np.random.default_rng(7)
    dx = np.zeros(12, np.float32)
    dx[0:3] = rng.normal(size=3) * 0.02
    dx[6:9] = rng.normal(size=3) * 0.02
    return X0 + dx


def _camera_rays(n=48, seed=0):
    rng = np.random.default_rng(seed)
    pose = np.asarray(jagent.body_state_to_camera_pose(jnp.asarray(_perturbed())))
    inds = rng.integers(0, H * W, n)
    r = jrays.get_rays_at(jnp.asarray(pose), jnp.asarray(INTR), W, jnp.asarray(inds))
    return pose, inds, np.asarray(r["rays_o"]), np.asarray(r["rays_d"])


def test_get_rays_at():
    pose, inds, o, d = _camera_rays()
    r = trays.get_rays_at(torch.as_tensor(pose), torch.as_tensor(INTR), W, torch.as_tensor(inds))
    np.testing.assert_allclose(r["rays_o"].numpy(), o, rtol=0, atol=1e-6)
    np.testing.assert_allclose(r["rays_d"].numpy(), d, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(r["inds"].numpy(), inds)


@pytest.mark.parametrize("kind,upsample,keyed", [
    ("textured", 0, False), ("textured", 16, True), ("float32", 0, True),
    ("float32", 16, False), ("float32", 16, True)])
def test_render_rays(kind, upsample, keyed):
    """render_rays with the JAX key's draws passed in: key -> (jitter key,
    pdf key) as the JAX function splits it."""
    fj, ft = _fields(kind)
    rj = jrend.RenderConfig(num_steps=24, upsample_steps=upsample, min_near=0.05)
    rt = trend.RenderConfig(num_steps=24, upsample_steps=upsample, min_near=0.05)
    _, _, o, d = _camera_rays()
    key = jax.random.PRNGKey(11) if keyed else None
    jitter = u = None
    if keyed:
        k, sub = jax.random.split(key)
        jitter = torch.as_tensor(np.asarray(jax.random.uniform(sub, (o.shape[0], 24))))
        if upsample:
            _, sub = jax.random.split(k)
            u = torch.as_tensor(np.asarray(jax.random.uniform(sub, (o.shape[0], upsample))))
    want = jax.jit(lambda o_, d_: jrend.render_rays(fj, rj, o_, d_, key=key, bg_color=0.3))(
        jnp.asarray(o), jnp.asarray(d))
    got = trend.render_rays(ft, rt, torch.as_tensor(o), torch.as_tensor(d), jitter=jitter, u=u,
                            bg_color=0.3)
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("num", [2, 24, 128, 513])
def test_linspace_bits(num):
    """The dense lattice's linspace: i / (num - 1) rounded once, within a bit
    of jnp.linspace (which multiplies by the reciprocal), and one shared
    constant per device, so every device samples at the same bits."""
    s = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    got = trend.linspace(0.0, 1.0, num, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.append(s, np.float32(1.0)))
    want = np.asarray(jax.jit(lambda: jnp.linspace(0.0, 1.0, num, dtype=jnp.float32))())
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    assert trend.linspace(0.0, 1.0, num, "cpu") is got


def test_sample_pdf_and_render_image():
    rng = np.random.default_rng(3)
    w = rng.uniform(0, 1, (10, 7)).astype(np.float32)
    bins = np.cumsum(rng.uniform(0.01, 0.1, (10, 8)), -1).astype(np.float32)
    key = jax.random.PRNGKey(2)
    for k in (None, key):
        want = jrend.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 5, k)
        u = None if k is None else torch.as_tensor(np.asarray(jax.random.uniform(k, (10, 5))))
        got = trend.sample_pdf(torch.as_tensor(bins), torch.as_tensor(w), 5, u)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    fj, ft = _fields("textured")
    rj = jrend.RenderConfig(num_steps=16, upsample_steps=0, min_near=0.05, max_ray_batch=20)
    rt = trend.RenderConfig(num_steps=16, upsample_steps=0, min_near=0.05, max_ray_batch=20)
    _, _, o, d = _camera_rays(n=47)
    want = jrend.render_image(fj, rj, jnp.asarray(o), jnp.asarray(d))
    got = trend.render_image(ft, rt, torch.as_tensor(o), torch.as_tensor(d))
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5)


def _frozen_lattice(o, d, k=16):
    occ, _ = shell_occupancy(32, 1)
    mcfg = tm.MarchConfig(bound=1.0, grid_size=32, max_steps=256, samples_per_ray=k,
                          min_near=0.05, coarse_segments=12, coarse_anchors=2)
    m = tm.march(torch.as_tensor(o), torch.as_tensor(d), occupancy_from_numpy(occ, "cpu"), mcfg)
    return m["z"].numpy(), m["dt"].numpy(), m["valid"].numpy()


@pytest.mark.parametrize("kind", ["textured", "float32"])
def test_render_rays_frozen(kind):
    fj, ft = _fields(kind)
    _, _, o, d = _camera_rays()
    z, dt, valid = _frozen_lattice(o, d)
    assert valid.any()
    want = jrend.render_rays_frozen(fj, 1.0, *map(jnp.asarray, (o, d, z, dt, valid)),
                                    bg_color=1.0)
    got = trend.render_rays_frozen(ft, 1.0, *map(torch.as_tensor, (o, d, z, dt, valid)),
                                   bg_color=1.0)
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,tol", [("textured", 1e-4), ("float32", 1e-4),
                                      ("bfloat16", 3e-2)])
def test_residual_jacobian(kind, obs, tol):
    """J of the LM residuals: torch.func.jacfwd here against jax.linearize
    plus a vmap over the 12 unit tangents, as the JAX solver builds it."""
    ej, et, fj, _ = _estimators(kind, steps=24)
    img_f = obs.astype(np.float32) / 255.0
    rng = np.random.default_rng(1)
    inds = rng.integers(0, H * W, 24)
    gt = img_f.reshape(-1, 3)[inds]
    x = _perturbed()
    x_pred = X0.copy()
    a = rng.normal(size=(12, 12)).astype(np.float32)
    sig_chol = (a @ a.T / 12 + np.eye(12)).astype(np.float32)
    rj = jrend.RenderConfig(num_steps=24, upsample_steps=0, min_near=0.05)

    def res_j(xx):
        pose = jagent.body_state_to_camera_pose(xx)
        rays = jrays.get_rays_at(pose, jnp.asarray(INTR), W, jnp.asarray(inds))
        out = jrend.render_rays(fj, rj, rays["rays_o"], rays["rays_d"], bg_color=1.0)
        scale = jnp.sqrt(1e3 / (gt.shape[0] * 3.0))
        r_photo = ((out["image"] - jnp.asarray(gt)) * scale).reshape(-1)
        return jnp.concatenate([r_photo, jnp.asarray(sig_chol).T @ (xx - jnp.asarray(x_pred))])

    @jax.jit
    def jac(xx):
        r, lin = jax.linearize(res_j, xx)
        return r, jax.vmap(lin)(jnp.eye(12))

    r_want, jt_want = jac(jnp.asarray(x))
    args = (torch.as_tensor(inds), torch.as_tensor(gt), torch.as_tensor(x_pred),
            torch.as_tensor(sig_chol))
    J = jacfwd(lambda v: et.residuals_of(v, *args))(torch.as_tensor(x))
    r_got = et.residuals_of(torch.as_tensor(x), *args)
    _close(r_got.detach().numpy(), r_want, 1e-5 if kind != "bfloat16" else tol)
    _close(J.T.numpy(), jt_want, tol)
    assert np.abs(np.asarray(jt_want)).max() > 0.1  # the renderer moves with the pose


def _jax_sel(key, n, pool):
    return np.asarray(jax.random.randint(key, (n,), 0, pool))


@pytest.mark.parametrize("frozen", [False, True])
def test_gn_fused_injected_draws(obs, frozen):
    """gn_fused (predict, conditioning, LM, posterior) from the same state
    and the JAX key's pixel draws; then estimate_state end to end."""
    lattice = None
    ej, et, _, _ = _estimators()
    _, _, pool_j, gt_j, _ = ej._front_end(obs)
    _, _, pool_t, gt_t, _ = et._front_end(obs)
    np.testing.assert_array_equal(pool_t.numpy(), np.asarray(pool_j))
    np.testing.assert_array_equal(gt_t.numpy(), np.asarray(gt_j))
    sub = jax.random.split(jax.random.PRNGKey(0))[1]
    sel = _jax_sel(sub, EST_KW["batch_size"], EST_KW["pool_size"])
    if frozen:  # march once at the predicted pose, shared by both sides
        x_pred = et._predict(torch.as_tensor(_perturbed()),
                             torch.tensor([10.0, 0, 0, 0]))[0].detach()
        pose = tagent.body_state_to_camera_pose(x_pred)
        r = trays.get_rays_at(pose, torch.as_tensor(INTR), W, pool_t[torch.as_tensor(sel)])
        lattice = _frozen_lattice(r["rays_o"].numpy(), r["rays_d"].numpy())
        ej, et, _, _ = _estimators(frozen=lattice)
    xt = _perturbed()
    act = np.asarray([10.0, 0.0, 0.0, 0.0], np.float32)
    sig = np.eye(12, dtype=np.float32) * 0.5
    ej._jit_cache[(H, W)] = ej._build_update(H, W)  # estimate_state reuses it
    want = ej._jit_cache[(H, W)][3](jnp.asarray(xt), jnp.asarray(act), jnp.asarray(sig),
                                    pool_j, EST_KW["pool_size"], gt_j, sub)
    got = et.gn_fused(torch.as_tensor(xt), torch.as_tensor(act), torch.as_tensor(sig), pool_t,
                      gt_t, torch.as_tensor(sel))
    for name, g, w, tol in zip(("x_pred", "sig_pred", "x", "sig_post", "losses"), got, want,
                               (1e-6, 1e-5, 1e-4, 1e-4, 1e-4)):
        _close(g.numpy(), w, tol)
    losses = got[4].numpy()
    assert (np.diff(losses) <= 0).all()  # LM accepts only descents
    if not frozen:  # the dense solve moves toward the true pose
        assert np.abs(got[2].numpy() - X0).max() < np.abs(xt - X0).max()

    # estimate_state end to end, with the JAX key's draws injected
    ej.set_initial_state(xt)
    et.set_initial_state(xt)
    et.draw_sel = lambda n=None: torch.as_tensor(sel)
    pose_gt = np.asarray(jagent.body_state_to_camera_pose(jnp.asarray(X0)))
    _close(et.estimate_state(obs, pose_gt, act), ej.estimate_state(obs, pose_gt, act), 1e-4)
    _close(et.sig.numpy(), ej.sig, 1e-4)
    assert et.iteration == ej.iteration == 1


def test_gn_core_injected_draws(obs):
    """gn_core alone (the LM solve from a given whitening factor): x, the
    losses and 2 J^T J against the JAX solver's jitted gn_core."""
    ej, et, _, _ = _estimators(gn_iters=3)
    _, _, pool_j, gt_j, _ = ej._front_end(obs)
    _, _, pool_t, gt_t, _ = et._front_end(obs)
    key = jax.random.PRNGKey(3)
    sel = _jax_sel(key, EST_KW["batch_size"], EST_KW["pool_size"])
    x0, x_pred = _perturbed(), X0.copy()
    a = np.random.default_rng(2).normal(size=(12, 12)).astype(np.float32) * 0.1
    sig_chol = (np.eye(12) + a).astype(np.float32)
    want = ej._build_update(H, W)[2](jnp.asarray(x0), pool_j, EST_KW["pool_size"], gt_j,
                                     jnp.asarray(x_pred), jnp.asarray(sig_chol), key)
    got = et.gn_core(torch.as_tensor(x0), pool_t, gt_t, torch.as_tensor(x_pred),
                     torch.as_tensor(sig_chol), torch.as_tensor(sel))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-4)


def test_adam_update_injected_draws(obs):
    """The Adam path: opt_run over n_iters steps, each on its own draws (the
    JAX scan's split keys), and the measurement Hessian."""
    ej, et, _, _ = _estimators(optimizer="adam", batch_size=32)
    _, _, pool_j, gt_j, _ = ej._front_end(obs)
    _, _, pool_t, gt_t, _ = et._front_end(obs)
    opt_run, hess_fn, _, _ = ej._build_update(H, W)
    x = _perturbed()
    x_pred = X0.copy()
    sig_inv = np.eye(12, dtype=np.float32) * 2.0
    rng = jax.random.PRNGKey(4)
    keys = jax.random.split(rng, EST_KW["n_iters"])
    sels = np.stack([_jax_sel(k, 32, EST_KW["pool_size"]) for k in keys])
    xw, _, lw = opt_run(jnp.asarray(x), ej._opt.init(jnp.asarray(x)), pool_j,
                        EST_KW["pool_size"], gt_j, jnp.asarray(x_pred), jnp.asarray(sig_inv), rng)
    xg, _, lg = et.opt_run(torch.as_tensor(x), None, pool_t, gt_t, torch.as_tensor(x_pred),
                           torch.as_tensor(sig_inv), torch.as_tensor(sels))
    _close(lg.numpy(), lw, 1e-4)
    _close(xg.numpy(), xw, 1e-4)
    hw = hess_fn(xw, pool_j, EST_KW["pool_size"], gt_j, jnp.asarray(x_pred),
                 jnp.asarray(sig_inv), keys[0])
    hg = et.hess_fn(torch.as_tensor(np.asarray(xw)), pool_t, gt_t, torch.as_tensor(x_pred),
                    torch.as_tensor(sig_inv), torch.as_tensor(sels[0]))
    _close(hg.detach().numpy(), hw, 1e-3)


def test_interest_mask_equals_cv2_dilate(obs):
    """scipy's binary dilation (5x5 square, 3 iterations, zero border) is
    the JAX package's cv2.dilate mask, keypoints at the borders included."""
    rng = np.random.default_rng(9)
    for hw, n in (((32, 32), 6), ((40, 57), 12), ((17, 9), 3)):
        poi = np.stack([rng.integers(0, hw[1], n), rng.integers(0, hw[0], n)], -1)
        poi[0] = [0, 0]
        poi[-1] = [hw[1] - 1, hw[0] - 1]
        for ks, it in ((5, 3), (3, 1)):
            np.testing.assert_array_equal(test_.interest_region_mask(hw, poi, ks, it),
                                          jest.interest_region_mask(hw, poi, ks, it))
    assert not test_.interest_region_mask((8, 8), np.zeros((0, 2), int)).any()
    for backend, ds in (("sift", 1), ("orb", 2), ("corners", 1)):
        np.testing.assert_array_equal(test_.find_poi(obs, backend=backend, downscale=ds),
                                      jest.find_poi(obs, backend=backend, downscale=ds))


def test_no_feature_fallback():
    """A flat image gives no keypoints: both filters return the prediction
    and the nearest-PD-conditioned predicted covariance."""
    ej, et, _, _ = _estimators()
    flat = np.full((H, W, 3), 128, np.uint8)
    act = np.asarray([10.2, 0.001, 0.0, -0.002], np.float32)
    for e in (ej, et):
        e.set_initial_state(_perturbed())
    _close(et.estimate_state(flat, None, act), ej.estimate_state(flat, None, act), 1e-6)
    _close(et.sig.numpy(), ej.sig, 1e-5)
    assert et.iteration == 1


def test_agent_observation_within_one_lsb(obs):
    cfg = tagent.AgentConfig(dyn=TDyn(dt=0.2), H=H, W=W, focal=FOCAL)
    agent = tagent.Agent(X0, cfg, field=tsyn.textured_sphere_field(), render_chunk=300,
                         device="cpu")
    pose = tagent.body_state_to_camera_pose(torch.as_tensor(X0)).numpy()
    np.testing.assert_allclose(pose, np.asarray(jagent.body_state_to_camera_pose(
        jnp.asarray(X0))), atol=1e-6)
    img = agent.get_img(pose)
    assert img.dtype == np.uint8 and img.shape == (H, W, 3)
    assert np.abs(img.astype(int) - obs.astype(int)).max() <= 1
    img2, state, _ = agent.step(np.asarray([10.0, 0, 0, 0], np.float32))  # hover
    np.testing.assert_allclose(state, X0, atol=1e-5)
    assert np.abs(img2.astype(int) - obs.astype(int)).max() <= 1
    noisy = tagent.add_noise_to_state(X0, 0.01, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(noisy, jagent.add_noise_to_state(
        X0, 0.01, rng=np.random.default_rng(0)))


def _mpc_pair(seed=0):
    _, et, _, ft = _estimators()
    et.gen.manual_seed(seed)
    et.set_initial_state(X0)
    start18 = np.zeros(18, np.float32)
    start18[0:3] = X0[0:3]
    start18[6:15] = np.eye(3).reshape(-1)
    end18 = start18.copy()
    end18[0:3] = [0.0, 1.2, 0.1]
    traj = Planner(start18, end18, PlannerConfig(T=5, dt=0.2, epochs_update=4,
                                                 body_nbins=(3, 3, 2)),
                   lambda x: ft.density_fn(x)[0], device="cpu")
    return et, traj


def test_fused_tick_matches_unfused_sequence(obs):
    """Two ticks of FusedMPC against estimate_state -> update_state ->
    learn_update -> get_next_action from the same state and draws."""
    filt_a, traj_a = _mpc_pair()
    filt_b, traj_b = _mpc_pair()
    fused = FusedMPC(filt_b, traj_b, H, W)
    action = np.asarray([10.0, 0, 0, 0], np.float32)
    for tick in range(2):
        x_a = filt_a.estimate_state(obs, None, action)
        traj_a.update_state(x_a)
        traj_a.learn_update(tick)
        act_a = traj_a.get_next_action().detach().numpy()
        x_b, act_b = fused.step(obs, action)
        np.testing.assert_allclose(x_a, x_b.numpy(), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(filt_a.sig.numpy(), filt_b.sig.numpy(), rtol=2e-3,
                                   atol=2e-4)
        assert traj_a.active == traj_b.active == 4 - tick
        np.testing.assert_allclose(traj_a.states.numpy(), traj_b.states.numpy(), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(act_a, act_b.numpy(), rtol=2e-3, atol=2e-4)
        action = act_a
    assert filt_b.iteration == 2 and traj_b.epoch == 8


def test_fused_requires_static_horizon_and_gn():
    import dataclasses

    filt, traj = _mpc_pair()
    traj.cfg = dataclasses.replace(traj.cfg, static_horizon=False)
    with pytest.raises(ValueError):
        FusedMPC(filt, traj, H, W)
    # render_viz builds (it once raised as unported); test_torch_viz.py runs it
    assert test_.EstimatorConfig(render_viz=True).render_viz
