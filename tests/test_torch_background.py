"""nerfnav_tpu_torch's background network for unbounded scenes (bg_radius >
0), frequency-encoded fields and param_groups vs the JAX package's, on the
CPU, on the same params (the JAX init carried across with
params_from_numpy).

fp32 paths (mlp_backend "xla", float32 tables) agree within 1e-5 (gradients
of each tensor's largest entry); sph_from_ray within 1e-6; the bf16 MLP and
the fused MLP within 2e-2 (the JAX side runs its Pallas kernel in
interpret mode, the port its plain version; tests/test_torch_render.py
states why). The grid renders shade the port's march, which
tests/test_torch_march.py holds against the JAX march run op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

from nerfnav_tpu.models import network as jnet
from nerfnav_tpu.models import renderer as jrend
from nerfnav_tpu.ops import marching as jm
from nerfnav_tpu.training import checkpoint as jckpt
from nerfnav_tpu.training import Trainer as JTrainer, TrainerOptions as JOpts
from nerfnav_tpu_torch.models import network as tnet
from nerfnav_tpu_torch.models import renderer as trend
from nerfnav_tpu_torch.ops import marching as tm
from nerfnav_tpu_torch.training import checkpoint as tckpt
from nerfnav_tpu_torch.training import trainer as ttrain
from nerfnav_tpu_torch.training.checkpoint import occupancy_from_numpy, params_from_numpy
from test_torch_march import camera_rays, shell_occupancy
from test_torch_render import _march_by_port, _trainers as _render_trainers
from test_torch_train import (
    _dataset, _draws_from_key, _grads_close, _patch_march, _trainers as _train_trainers,
)

torch.set_num_threads(1)

BG_RADIUS = 6.0
BF16_TOL = 2e-2


def _net_kw(**kw):
    base = dict(bound=1.0, grid_levels=2, grid_level_dim=8, grid_log2_hashmap_size=10,
                grid_max_resolution=32, grid_layout="cell", density_scale=8.0,
                bg_radius=BG_RADIUS)
    base.update(kw)
    return base


def _params(kw, seed=0):
    pj = jnet.init_network(jax.random.PRNGKey(seed), jnet.NetworkConfig(**kw))
    # the bg tables start at 1e-4: scale them so the background varies
    pj = {k: [a * 1e3 for a in v] if k == "bg_encoder" else v for k, v in pj.items()}
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")


def _sph_by_port(monkeypatch):
    """Let the JAX renderers take the port's sphere coordinates (a host
    callback; no derivative w.r.t. the rays passes it). XLA's atan2 and acos
    and torch's differ by an ulp (test_sph_from_ray_seam_and_poles holds
    them within 1e-6), and the 2-D grid's levels at resolution 407 and 2048
    turn that ulp into a 1e-5 relative change of a table gradient."""
    def sph_j(rays_o, rays_d, radius):
        def run(o, d):
            return trend.sph_from_ray(torch.as_tensor(np.array(o)),
                                      torch.as_tensor(np.array(d)), radius).numpy()

        return jax.pure_callback(run, jax.ShapeDtypeStruct((rays_o.shape[0], 2), jnp.float32),
                                 rays_o, rays_d)

    monkeypatch.setattr(jrend, "sph_from_ray", sph_j)


def _fields(kw, pj, pt):
    return (jrend.make_field(pj, jnet.NetworkConfig(**kw)),
            trend.make_field(pt, tnet.NetworkConfig(**kw)))


def _close(a, b, tol=1e-5):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol)


def _seam_and_pole_rays():
    """Rays from inside the sphere: random ones, ones that leave it at the
    azimuth seam (the -x axis, on both sides of y = 0) and at the poles."""
    rng = np.random.default_rng(0)
    o = rng.uniform(-0.8, 0.8, (60, 3)).astype(np.float32)
    d = rng.normal(size=(60, 3)).astype(np.float32)
    o[:6] = 0.0
    d[:6] = [[0, 0, 1], [0, 0, -1], [-1, 0, 0], [-1, 0, 0.5], [0, 0, 2.5], [0, 0, -0.3]]
    o[6:10] = [[0.2, 0.0, 0.1], [0.2, -0.0, 0.1], [0.3, 1e-7, 0], [0.3, -1e-7, 0]]
    d[6:10] = [[-1, 0, 0.2], [-1, -0.0, 0.2], [-1, 0, 0], [-1, 0, 0]]
    o[10:12] = [[0.1, 0.2, 0.3], [-0.1, 0.2, -0.3]]
    d[10:12] = [[-0.1 / BG_RADIUS, -0.2 / BG_RADIUS, 1.0], [0.1 / BG_RADIUS, -0.2 / BG_RADIUS,
                                                          -1.0]]  # near the poles
    return o, d


def test_sph_from_ray_seam_and_poles():
    o, d = _seam_and_pole_rays()
    sj = np.asarray(jrend.sph_from_ray(jnp.asarray(o), jnp.asarray(d), BG_RADIUS))
    st = trend.sph_from_ray(torch.as_tensor(o), torch.as_tensor(d), BG_RADIUS).numpy()
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    assert np.abs(st).max() <= 1.0
    np.testing.assert_array_equal(st[:2, 1], [-1.0, 1.0])  # the poles
    np.testing.assert_array_equal(st[[2, 6, 8], 0], [1.0, 1.0, 1.0])  # the seam, y = +0
    np.testing.assert_array_equal(st[[7, 9], 0], [-1.0, -1.0])  # y < 0 (or -0)
    # the gradient w.r.t. the rays, away from the poles' infinite slope
    w = np.random.default_rng(1).normal(size=(48, 2)).astype(np.float32)
    gj = jax.grad(lambda a, b: jnp.sum(jrend.sph_from_ray(a, b, BG_RADIUS) * w),
                  argnums=(0, 1))(jnp.asarray(o[12:]), jnp.asarray(d[12:]))
    ot, dt = (torch.as_tensor(a[12:]).requires_grad_() for a in (o, d))
    (trend.sph_from_ray(ot, dt, BG_RADIUS) * torch.as_tensor(w)).sum().backward()
    for a, b in zip((ot.grad, dt.grad), gj):
        _close(a, b, 1e-5 * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("mode", ["xla_f32", "xla_bf16", "fused"])
def test_background_network(mode):
    """background() on sphere coordinates that cover the square, its edges
    included, and un-normalized directions: xla f32 within 1e-5, the bf16
    MLP and the fused MLP within BF16_TOL."""
    kw = _net_kw(mlp_dtype="bfloat16" if mode == "xla_bf16" else "float32",
                 mlp_backend="fused" if mode == "fused" else "xla")
    pj, pt = _params(kw)
    rng = np.random.default_rng(2)
    sph = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
    sph[:4] = [[-1, -1], [1, 1], [1, -1], [-1, 0.5]]
    d = rng.normal(size=(300, 3)).astype(np.float32)
    bj = jax.jit(lambda p, a, b: jnet.background(p, a, b, jnet.NetworkConfig(**kw)))(
        pj, jnp.asarray(sph), jnp.asarray(d))
    bt = tnet.background(pt, torch.as_tensor(sph), torch.as_tensor(d),
                         tnet.NetworkConfig(**kw))
    assert bt.shape == (300, 3) and bt.dtype == torch.float32
    assert float(bt.std()) > 1e-3  # the scaled bg tables reach the colour
    _close(bt, bj, 1e-5 if mode == "xla_f32" else BF16_TOL)


def test_param_groups_and_init_layout():
    """param_groups' labels equal JAX's for a bg field and a frequency
    field; init_network draws the JAX shapes, bg_* after the field's."""
    for kw in (_net_kw(), _net_kw(encoding="frequency", encoding_dir="frequency",
                                  bg_radius=-1.0)):
        pj = jnet.init_network(jax.random.PRNGKey(0), jnet.NetworkConfig(**kw))
        pt = tnet.init_network(torch.Generator().manual_seed(0), tnet.NetworkConfig(**kw),
                               device="cpu")
        assert tnet.param_groups(pt) == jnet.param_groups(pj)
        assert {k: [tuple(t.shape) for t in v] for k, v in pt.items()} == {
            k: [tuple(np.shape(a)) for a in v] for k, v in pj.items()}
    assert tnet.param_groups(pt) == {"sigma_net": "net", "color_net": "net"}
    # the field's draws come first: adding the bg net leaves them unchanged
    a = tnet.init_network(torch.Generator().manual_seed(0),
                          tnet.NetworkConfig(**_net_kw()), device="cpu")
    b = tnet.init_network(torch.Generator().manual_seed(0),
                          tnet.NetworkConfig(**_net_kw(bg_radius=-1.0)), device="cpu")
    assert set(a) - set(b) == {"bg_encoder", "bg_net"}
    assert all(torch.equal(x, y) for k in b for x, y in zip(a[k], b[k]))


def test_frequency_field_forward_and_render():
    """A frequency-encoded field (position and direction): forward() and
    the dense render with importance samples, within 1e-5."""
    kw = _net_kw(encoding="frequency", encoding_dir="frequency", bound=1.5, bg_radius=-1.0,
                 density_scale=2.0)
    pj, pt = _params(kw)
    assert "encoder" not in pt
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for a, b in zip(tnet.forward(pt, torch.as_tensor(x), torch.as_tensor(d),
                                 tnet.NetworkConfig(**kw)),
                    jnet.forward(pj, jnp.asarray(x), jnp.asarray(d), jnet.NetworkConfig(**kw))):
        _close(a, b, 1e-5 * max(1.0, float(np.abs(np.asarray(b)).max())))
    fj, ft = _fields(kw, pj, pt)
    o, dd = camera_rays(8, 1.5, focal=10.0)
    rcfg = dict(num_steps=16, upsample_steps=8, min_near=0.05)
    oj = jax.jit(lambda a, b: jrend.render_rays(fj, jrend.RenderConfig(**rcfg), a, b))(
        jnp.asarray(o), jnp.asarray(dd))
    ot = trend.render_rays(ft, trend.RenderConfig(**rcfg), torch.as_tensor(o),
                           torch.as_tensor(dd))
    for k in ("image", "depth", "weights_sum"):
        _close(ot[k], oj[k])


def _dense_draws(key, n, t, up):
    """render_rays' jitter and importance draws, split as its key is."""
    k1, s1 = jax.random.split(key)
    _, s2 = jax.random.split(k1)
    return (torch.as_tensor(np.array(jax.random.uniform(s1, (n, t)))),
            torch.as_tensor(np.array(jax.random.uniform(s2, (n, up)))))


def test_render_rays_dense_with_bg():
    """The dense render with a bg net (jitter and importance draws from the
    JAX key), and the background alone (an empty field): image, depth and
    weights_sum within 1e-5; a bg_color has no effect."""
    kw = _net_kw(density_scale=0.5)
    pj, pt = _params(kw)
    fj, ft = _fields(kw, pj, pt)
    o, d = camera_rays(8, 1.0, focal=10.0)
    rcfg = dict(num_steps=16, upsample_steps=8, min_near=0.05)
    key = jax.random.PRNGKey(4)
    jit, u = _dense_draws(key, o.shape[0], 16, 8)
    oj = jax.jit(lambda a, b: jrend.render_rays(fj, jrend.RenderConfig(**rcfg), a, b,
                                                key=key))(jnp.asarray(o), jnp.asarray(d))
    ot = trend.render_rays(ft, trend.RenderConfig(**rcfg), torch.as_tensor(o),
                           torch.as_tensor(d), jitter=jit, u=u, bg_color=0.3)
    ws = np.asarray(oj["weights_sum"])
    assert ws.min() < 0.9  # the background shows
    for k in ("image", "depth", "weights_sum"):
        _close(ot[k], oj[k])
    # empty field: the image is the background network's colour
    empty = ft._replace(density_fn=lambda x: (torch.zeros(x.shape[0]),
                                              torch.zeros(x.shape[0], 15)))
    img = trend.render_rays(empty, trend.RenderConfig(**rcfg), torch.as_tensor(o),
                            torch.as_tensor(d))["image"]
    sph = trend.sph_from_ray(torch.as_tensor(o), torch.as_tensor(d), BG_RADIUS)
    _close(img, np.clip(ft.bg_fn(sph, torch.as_tensor(d)).numpy(), 0, 1), 1e-6)


@pytest.mark.parametrize("budget", [None, 1024])
def test_render_rays_grid_with_bg_and_grads(budget, monkeypatch):
    """The training render with a bg net, dense and packed: image, depth
    and every param's gradient, the bg leaves included, within 1e-5 (the
    JAX side on the port's sphere coordinates, see _sph_by_port)."""
    _sph_by_port(monkeypatch)
    kw = _net_kw(bound=2.0)
    pj, pt = _params(kw)
    occ, _ = shell_occupancy(32, 2)
    mkw = dict(bound=2.0, grid_size=32, max_steps=256, samples_per_ray=16, min_near=0.05,
               coarse_normalized=False)
    o, d = camera_rays(16, 2.0, focal=14.0)
    n = o.shape[0]
    rng = np.random.default_rng(7)
    mkey = tm.MarchKey(u=torch.as_tensor(rng.random(n, dtype=np.float32)),
                       phase=torch.as_tensor(rng.integers(0, 2**30, (n, 1))))
    occ_t = occupancy_from_numpy(occ, device="cpu")
    m_t = tm.march(torch.as_tensor(o), torch.as_tensor(d), occ_t, tm.MarchConfig(**mkw),
                   key=mkey)
    assert int(m_t["valid"].sum()) > 1024
    monkeypatch.setattr(jm, "march", lambda *a, **k: {
        key: jnp.asarray(v.numpy()) for key, v in m_t.items()})
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wd = rng.normal(size=(n,)).astype(np.float32)

    def loss_j(p):
        out = jrend.render_rays_grid(jrend.make_field(p, jnet.NetworkConfig(**kw)), None,
                                     jm.MarchConfig(**mkw), jnp.asarray(o), jnp.asarray(d),
                                     sample_budget=budget)
        return jnp.sum(out["image"] * wi) + jnp.sum(out["depth"] * wd), out

    (_, oj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(pj)
    leaves = [t.requires_grad_() for k in sorted(pt) for t in pt[k]]
    ot = trend.render_rays_grid(trend.make_field(pt, tnet.NetworkConfig(**kw)), occ_t,
                                tm.MarchConfig(**mkw), torch.as_tensor(o),
                                torch.as_tensor(d), key=mkey, sample_budget=budget)
    ((ot["image"] * torch.as_tensor(wi)).sum() + (ot["depth"] * torch.as_tensor(wd)).sum()
     ).backward()
    assert float(ot["weights_sum"].detach().min()) < 0.9
    for k in ("image", "depth", "weights_sum"):
        _close(ot[k], oj[k])
    _grads_close([t.grad.numpy() for t in leaves],
                 [np.asarray(g) for g in jax.tree_util.tree_leaves(gj)], 1e-5)


def test_frozen_and_rounds_with_bg(monkeypatch):
    """render_rays_frozen on the port's march and render_rays_grid_rounds
    (the background once per chunk, after the rounds) with a bg net."""
    kw = _net_kw()
    pj, pt = _params(kw)
    fj, ft = _fields(kw, pj, pt)
    occ, _ = shell_occupancy(32, 1)
    mkw = dict(bound=1.0, grid_size=32, max_steps=256, samples_per_ray=16, min_near=0.05)
    o, d = camera_rays(16, 1.0, focal=20.0)
    occ_t = occupancy_from_numpy(occ, device="cpu")
    m_t = tm.march(torch.as_tensor(o), torch.as_tensor(d), occ_t, tm.MarchConfig(**mkw))
    m_j = {k: jnp.asarray(v.numpy()) for k, v in m_t.items()}
    oj = jax.jit(lambda a, b, z, dt, v: jrend.render_rays_frozen(fj, 1.0, a, b, z, dt, v))(
        jnp.asarray(o), jnp.asarray(d), m_j["z"], m_j["dt"], m_j["valid"])
    ot = trend.render_rays_frozen(ft, 1.0, torch.as_tensor(o), torch.as_tensor(d), m_t["z"],
                                  m_t["dt"], m_t["valid"], bg_color=0.0)
    for k in ("image", "depth", "weights_sum"):
        _close(ot[k], oj[k])
    monkeypatch.setattr(jm, "march", lambda *a, **k: m_j)
    occ_j = {k: jnp.asarray(v) for k, v in occ.items()}
    args = dict(round_samples=4, round_compact=4)
    oj = jax.jit(lambda a, b: jrend.render_rays_grid_rounds(
        fj, occ_j, jm.MarchConfig(**mkw), a, b, **args))(jnp.asarray(o), jnp.asarray(d))
    ot = trend.render_rays_grid_rounds(ft, occ_t, tm.MarchConfig(**mkw), torch.as_tensor(o),
                                       torch.as_tensor(d), **args)
    assert np.asarray(oj["weights_sum"]).min() < 0.9
    for k in ("image", "depth", "weights_sum"):
        _close(ot[k], oj[k])


@pytest.mark.parametrize("grid", [True, False], ids=["rounds", "dense"])
def test_render_full_with_bg(tmp_path, grid, monkeypatch):
    """Trainer.render_full with a bg net, xla fp32 field and tables: the
    grid rounds path (the port's march) and the dense path, within 1e-5.
    The default eval table cast leaves the bg tables in float32."""
    kw = _net_kw()
    tj, tt, pose, intr = _render_trainers(
        tmp_path, kw, 1.0, dict(eval_beam=1, eval_table_dtype="float32"), grid=grid)
    if grid:
        _march_by_port(monkeypatch, tt.occupancy)
    ij, dj = tj.render_full(tj.params, pose, intr, 16, 16)
    it, dt = tt.render_full(tt.params, pose, intr, 16, 16)
    _close(it, ij)
    _close(dt, dj)
    tt.opt.eval_table_dtype = "bfloat16"
    cast = tt._cast_eval_tables(tt.params)
    assert cast["encoder"][0].dtype == torch.bfloat16
    assert cast["bg_encoder"][0].dtype == torch.float32


@pytest.mark.parametrize("path", ["grid", "dense", "dense_frequency"])
def test_train_step_with_bg(path, tmp_path, monkeypatch):
    """One train step with a bg net, on the grid path (the port's march) or
    the dense one (jitter and importance draws split from the JAX step's
    key as its step splits it), the latter also on a frequency-encoded
    field (no "encoder" params): the loss and every gradient leaf, bg_encoder
    and bg_net included, within 1e-5 (the gradients through Adam's first
    moment, 0.1 g; the JAX side on the port's sphere coordinates, see
    _sph_by_port). The dense field is kept translucent, so the background
    takes a share of every ray."""
    _sph_by_port(monkeypatch)
    net_kw = dict(bound=2.0, grid_levels=2, grid_level_dim=8, grid_log2_hashmap_size=10,
                  grid_max_resolution=32, grid_layout="cell", bg_radius=BG_RADIUS,
                  density_scale=10.0 if path == "grid" else 0.2)
    if path == "dense_frequency":
        net_kw.update(encoding="frequency", encoding_dir="frequency", freq_degree=4)
    ds = _dataset()
    H, W, C = ds.images.shape[1:]
    arrays_j = {k: jnp.asarray(v) for k, v in ds.as_arrays().items()}
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    if path == "grid":
        tj, tt = _train_trainers(tmp_path, net_kw, dt_anneal=((0.0, 2),))
        arrays_t = tt._device_arrays(ds)
        key = jax.random.PRNGKey(5)
        draws = _draws_from_key(key, None, 1, H, W)
        _patch_march(monkeypatch, tt, arrays_t, draws)
        step_j = tj._build_train_step(H, W, C, tj._dt_mult(), None)
    else:
        n, rkw = 64, dict(num_steps=16, upsample_steps=8, min_near=0.05)
        okw = dict(num_rays=n, iters=200, use_checkpoint="scratch")
        pj = jnet.init_network(jax.random.PRNGKey(0), jnet.NetworkConfig(**net_kw))
        tj = JTrainer(jnet.NetworkConfig(**net_kw), jrend.RenderConfig(**rkw),
                      JOpts(name="j", workspace=str(tmp_path / "j"), **okw), params=pj)
        tj.state = tj._init_state(2)
        tt = ttrain.Trainer(tnet.NetworkConfig(**net_kw), trend.RenderConfig(**rkw),
                            ttrain.TrainerOptions(name="t", workspace=str(tmp_path / "t"),
                                                  **okw),
                            params=params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                                     device="cpu"), device="cpu")
        arrays_t = tt._device_arrays(ds)
        key = jax.random.PRNGKey(9)
        k_ray, k_perturb, k_bg = jax.random.split(key, 3)
        k_up, k_jit = jax.random.split(k_perturb)
        draws = ttrain.StepDraws(
            idx=1, rays=ttrain.RayDraws(inds=t(jax.random.randint(k_ray, (n,), 0,
                                                                  H * W)).long()),
            bg=t(jax.random.uniform(k_bg, (n, 3))),
            jitter=t(jax.random.uniform(k_jit, (n, 16))),
            u=t(jax.random.uniform(jax.random.split(k_up)[1], (n, 8))))
        step_j = tj._build_train_step(H, W, C, 1, None)
    sj, loss_j = step_j(tj.state, arrays_j, jnp.asarray(1), key)
    out = tt.loss_and_grads(tt.state, arrays_t, draws)
    np.testing.assert_allclose(float(out.loss), float(loss_j), rtol=1e-5)
    names = [k for k in sorted(tt.params) for _ in tt.params[k]]
    assert names[:6] == ["bg_encoder"] * 4 + ["bg_net"] * 2
    assert ("encoder" in tt.params) == (path != "dense_frequency")
    _grads_close([0.1 * g.numpy() for g in out.grads],
                 [np.asarray(m) for m in jax.tree_util.tree_leaves(sj.opt_state[0].mu)], 1e-5)


def test_dense_render_jvp_with_bg():
    """The dense render's forward-mode derivative w.r.t. the rays (the pose
    filter's jacfwd) with a bg net: torch.func.jvp against jax.jvp for two
    tangents, image and depth within 1e-4 of the largest entry, the bound
    tests/test_torch_nav_estimator.py holds the filter's Jacobian to (the
    image's tangent reads 2e-5 to 3e-5 with and without the bg net: the
    hash grids' derivatives jump where an ulp moves a sample or a sphere
    coordinate into the next cell, and the 2-D grid's finest level has 2048
    cells a side)."""
    kw = _net_kw(density_scale=4.0)
    pj, pt = _params(kw)
    fj, ft = _fields(kw, pj, pt)
    o, d = camera_rays(6, 1.0, focal=8.0)
    rcfg = dict(num_steps=8, upsample_steps=4, min_near=0.05)
    tan_j = jax.jit(lambda a, b, ta, tb: jax.jvp(
        lambda a, b: jrend.render_rays(fj, jrend.RenderConfig(**rcfg), a, b), (a, b),
        (ta, tb))[1])
    rng = np.random.default_rng(5)
    for _ in range(2):
        to = rng.normal(size=o.shape).astype(np.float32)
        td = rng.normal(size=d.shape).astype(np.float32)
        tj = tan_j(*map(jnp.asarray, (o, d, to, td)))
        _, tt = jvp(lambda a, b: trend.render_rays(ft, trend.RenderConfig(**rcfg), a, b),
                    (torch.as_tensor(o), torch.as_tensor(d)),
                    (torch.as_tensor(to), torch.as_tensor(td)))
        for k in ("image", "depth"):
            b = np.asarray(tj[k])
            assert np.abs(b).max() > 0
            _close(tt[k], b, 1e-4 * np.abs(b).max())


@pytest.mark.parametrize("kind", ["bg", "frequency"])
def test_checkpoints_both_ways(tmp_path, kind):
    """Checkpoints with bg_* keys and without an encoder: the JAX package
    writes, the port's load_checkpoint_npz and Trainer resume read every
    leaf exactly; the port writes, JAX's load reads it exactly."""
    kw = (_net_kw() if kind == "bg" else
          _net_kw(encoding="frequency", encoding_dir="frequency", bg_radius=-1.0))
    pj, pt = _params(kw)
    jpath = str(tmp_path / "j" / "ngp_ep0003.npz")
    jckpt.save_checkpoint(jpath, {"params": pj, "ema_params": pj}, {"epoch": 3})
    jckpt.save_checkpoint(str(tmp_path / "j" / "ngp_best.npz"), pj, {"epoch": 3})
    for path in (jpath, str(tmp_path / "j" / "ngp_best.npz")):
        got = tckpt.load_checkpoint_npz(path, device="cpu")["ema_params"]
        assert sorted(got) == sorted(pj)
        for k in pj:
            for a, b in zip(got[k], pj[k]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tt = ttrain.Trainer(tnet.NetworkConfig(**kw), trend.RenderConfig(),
                        ttrain.TrainerOptions(name="t", workspace=str(tmp_path / "t"),
                                              use_checkpoint=jpath), device="cpu")
    tt._maybe_resume()
    assert tt.epoch == 3
    for k in pj:
        for a, b in zip(tt.params[k], pj[k]):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    tt.epoch = 4
    tt.save_checkpoint(full=True)
    like = {"params": pj, "ema_params": pj}
    tree, meta, report = jckpt.load_checkpoint(str(tmp_path / "t" / "checkpoints" /
                                                   "t_ep0004.npz"), like)
    assert not report and meta["epoch"] == 4
    for k in pj:
        for a, b in zip(tt.state.ema_params[k], tree["ema_params"][k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="bg_encoder with bg_net"):
        params_from_numpy({k: v for k, v in pj.items() if k != "bg_net"}
                          if kind == "bg" else {"sigma_net": pj["sigma_net"]}, device="cpu")
