"""nerfnav_tpu_torch planner against the JAX package's, on the CPU.

calc_everything (full horizon and static horizon with `active`) and
total_cost with its gradients agree within 1e-5 (relative to each array's
largest entry) on an analytic field and on a small xla float32 network
field. With a bfloat16 MLP the density is rounded at the MLP's casts, and
one rounding step can land on either side: there the cost agrees within
1e-3 and the gradients within 2e-2 of their largest entry. Five epochs of
learn_update (loss, backward, optax's clip and Adam) agree within 1e-5; A*
waypoints exactly; update_state, save_progress and load_progress round-trip
across the two packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfnav_tpu.data import synthetic as jsyn
from nerfnav_tpu.models import network as jnet
from nerfnav_tpu.models import renderer as jrend
from nerfnav_tpu.nav import planner as jplan
from nerfnav_tpu.nav.math_utils import vec_to_rot_matrix
from nerfnav_tpu_torch.data import synthetic as tsyn
from nerfnav_tpu_torch.models import network as tnet
from nerfnav_tpu_torch.models import renderer as trend
from nerfnav_tpu_torch.nav import planner as tplan
from nerfnav_tpu_torch.training.checkpoint import params_from_numpy

torch.set_num_threads(1)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


def _endpoints(seed=0):
    rng = np.random.default_rng(seed)
    s = np.zeros(18, np.float32)
    s[0:3] = [0.8, -0.7, 0.1]
    s[3:6] = rng.normal(size=3) * 0.1
    rv = jnp.asarray(rng.normal(size=3) * 0.1, jnp.float32)
    s[6:15] = np.asarray(vec_to_rot_matrix(rv)).reshape(-1)
    s[15:18] = rng.normal(size=3) * 0.2
    e = np.zeros(18, np.float32)
    e[0:3] = [-0.7, 0.75, 0.15]
    e[6:15] = np.eye(3).reshape(-1)
    return s, e


def _waypoints(T, seed=1):
    rng = np.random.default_rng(seed)
    s, e = _endpoints()
    a = np.linspace(0, 1, T + 2)[1:-1, None]
    pos = s[None, :3] * (1 - a) + e[None, :3] * a + rng.normal(size=(T, 3)) * 0.05
    yaw = rng.normal(size=(T, 1)) * 0.3
    accel = np.asarray([9.5, 10.4], np.float32)
    return np.concatenate([pos, yaw], -1).astype(np.float32), accel


def _cfgs(**kw):
    base = dict(T=6, dt=0.1, body_nbins=(3, 3, 2), epochs_update=5)
    base.update(kw)
    return jplan.PlannerConfig(**base), tplan.PlannerConfig(**base)


NET_KW = dict(bound=1.0, grid_levels=2, grid_level_dim=8, grid_log2_hashmap_size=10,
              grid_max_resolution=32, grid_layout="cell", density_scale=1.0)


def _fields(kind):
    """(jax density_fn, torch density_fn) of one field."""
    if kind == "cylinder":
        fj, ft = jsyn.cylinder_field(radius=0.3, sigma=40.0), tsyn.cylinder_field(
            radius=0.3, sigma=40.0)
    elif kind == "textured":
        fj, ft = jsyn.textured_sphere_field(), tsyn.textured_sphere_field()
    else:
        kw = dict(NET_KW, mlp_dtype=kind)
        pj = jnet.init_network(jax.random.PRNGKey(3), jnet.NetworkConfig(**kw))
        pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
        fj = jrend.make_field(pj, jnet.NetworkConfig(**kw))
        ft = trend.make_field(pt, tnet.NetworkConfig(**kw))
    return (lambda x: fj.density_fn(x)[0]), (lambda x: ft.density_fn(x)[0])


@pytest.mark.parametrize("name", ["sphere_field", "cylinder_field", "textured_sphere_field",
                                  "cluttered_field"])
def test_analytic_fields(name):
    """data/synthetic.py's closures: density and color within 1e-5."""
    fj, ft = getattr(jsyn, name)(), getattr(tsyn, name)()
    x = np.random.default_rng(6).uniform(-1, 1, (500, 3)).astype(np.float32)
    d = x / np.linalg.norm(x, axis=-1, keepdims=True)
    sj, gj = fj.density_fn(jnp.asarray(x))
    st, gt = ft.density_fn(torch.as_tensor(x))
    _close(st.numpy(), sj, 1e-5)
    _close(ft.color_fn(torch.as_tensor(d), gt).numpy(), fj.color_fn(jnp.asarray(d), gj), 1e-5)
    assert ft.bound == fj.bound


@pytest.mark.parametrize("active", [None, 6, 3])
def test_calc_everything(active):
    cj, ct = _cfgs()
    s, e = _endpoints()
    w, a = _waypoints(6)
    oj = jplan.calc_everything(*map(jnp.asarray, (s, e, w, a)), cj, active=active)
    ot = tplan.calc_everything(*map(torch.as_tensor, (s, e, w, a)), ct, active=active)
    for k in ("pos", "vel", "accel", "rot", "omega", "actions"):
        _close(ot[k].numpy(), oj[k], 1e-5)


@pytest.mark.parametrize("field,active,tol", [
    ("cylinder", None, (1e-5, 1e-5)), ("cylinder", 4, (1e-5, 1e-5)),
    ("textured", 6, (1e-5, 1e-5)), ("float32", None, (1e-5, 1e-5)),
    ("float32", 3, (1e-5, 1e-5)), ("bfloat16", 5, (1e-3, 2e-2))])
def test_total_cost_and_grads(field, active, tol):
    cj, ct = _cfgs()
    dj, dt_ = _fields(field)
    s, e = _endpoints()
    w, a = _waypoints(6)
    body_j, body_t = jplan.body_points(cj), tplan.body_points(ct)
    fade = np.linspace(0.2, 1.0, 10).astype(np.float32)

    def loss_j(w_, a_):
        return jplan.total_cost(jnp.asarray(s), jnp.asarray(e), w_, a_, dj, cj, body_j,
                                jnp.asarray(fade), active=active)[0]

    lj, (gwj, gaj) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(
        jnp.asarray(w), jnp.asarray(a))
    wt, at = torch.tensor(w, requires_grad=True), torch.tensor(a, requires_grad=True)
    lt, _ = tplan.total_cost(torch.as_tensor(s), torch.as_tensor(e), wt, at, dt_, ct, body_t,
                             torch.as_tensor(fade), active=active)
    gwt, gat = torch.autograd.grad(lt, [wt, at])
    _close(float(lt.detach()), float(lj), tol[0])
    _close(np.concatenate([gwt.numpy().ravel(), gat.numpy()]),
           np.concatenate([np.asarray(gwj).ravel(), np.asarray(gaj)]), tol[1])


@pytest.mark.parametrize("static,fade", [(True, 0), (True, 3), (False, 0)])
def test_learn_update_matches_jax_chunk(static, fade):
    """Five epochs from the same waypoints: states, initial_accel and
    losses within 1e-5."""
    cj, ct = _cfgs(static_horizon=static, fade_out_epoch=fade, lr=3e-3)
    dj, dt_ = _fields("cylinder")
    s, e = _endpoints()
    w, a = _waypoints(6)
    pj = jplan.Planner(s, e, cj, dj)
    pt = tplan.Planner(s, e, ct, dt_, device="cpu")
    pj.states, pj.initial_accel = jnp.asarray(w), jnp.asarray(a)
    pt.states, pt.initial_accel = torch.as_tensor(w), torch.as_tensor(a)
    if static:  # one pop first: the chunk then runs at active = T - 1
        pj.update_state(s)
        pt.update_state(s)
    lj, lt = pj.learn_update(0), pt.learn_update(0)
    _close(lt, lj, 1e-5)
    _close(pt.states.numpy(), pj.states, 1e-5)
    _close(pt.initial_accel.numpy(), pj.initial_accel, 1e-5)
    assert pt.epoch == pj.epoch == 5 and pt.active == pj.active
    _close(pt.get_next_action().numpy(), pj.get_next_action(), 1e-5)
    fj, ft = pj.get_full_states(), pt.get_full_states()
    for k in fj:
        _close(ft[k].numpy(), fj[k], 1e-5)


def test_learn_artifacts_chunked(tmp_path):
    """With a workspace the solve runs in save_every chunks (Adam state
    carried across them) and writes the same artifact files."""
    cj, ct = _cfgs(save_every=2, epochs_update=5)
    dj, dt_ = _fields("cylinder")
    s, e = _endpoints()
    pj = jplan.Planner(s, e, cj, dj, workspace=str(tmp_path / "j"), exp_name="x")
    pt = tplan.Planner(s, e, ct, dt_, workspace=str(tmp_path / "t"), exp_name="x",
                       device="cpu")
    # off the straight line: there some gradient entries are float32 noise,
    # which Adam's first steps blow up to +-lr in either package
    w, a = _waypoints(6)
    pj.states, pj.initial_accel = jnp.asarray(w), jnp.asarray(a)
    pt.states, pt.initial_accel = torch.as_tensor(w), torch.as_tensor(a)
    lj, lt = pj.learn_update(1), pt.learn_update(1)
    _close(lt, lj, 1e-5)
    _close(pt.states.numpy(), pj.states, 1e-5)
    names = sorted(p.name for p in (tmp_path / "t" / "replan_poses" / "x").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j" / "replan_poses" / "x").iterdir())
    assert names == ["replan_1_0.json", "replan_1_2.json", "replan_1_4.json"]


def test_astar_init_waypoints(monkeypatch):
    """The JAX planner runs its Python golden here (its native build breaks
    ties between equally short paths its own way); the port's native search
    matches that golden path for path."""
    from nerfnav_tpu.nav.astar import astar_python

    monkeypatch.setattr(jplan, "astar", astar_python)
    cj, ct = _cfgs(T=8, astar_fine=40, astar_coarse=20)
    dj, dt_ = _fields("cylinder")
    s, e = _endpoints()
    pj = jplan.Planner(s, e, cj, dj)
    pt = tplan.Planner(s, e, ct, dt_, device="cpu")
    assert pt.a_star_init() == pj.a_star_init()
    np.testing.assert_allclose(pt.states.numpy(), np.asarray(pj.states), rtol=0, atol=1e-6)
    # the path leaves the cylinder: no waypoint inside it
    assert (np.linalg.norm(pt.states.numpy()[:, :2], axis=-1) > 0.3).all()


def test_update_state_and_progress_files(tmp_path):
    """Pops in both horizon modes, then save_progress files read across the
    two packages in both directions."""
    for static in (True, False):
        cj, ct = _cfgs(static_horizon=static)
        dj, dt_ = _fields("cylinder")
        s, e = _endpoints()
        w, a = _waypoints(6)
        pj, pt = jplan.Planner(s, e, cj, dj), tplan.Planner(s, e, ct, dt_, device="cpu")
        pj.states, pt.states = jnp.asarray(w), torch.as_tensor(w)
        x12 = np.r_[s[0:6], [0.05, -0.02, 0.1], s[15:18]].astype(np.float32)
        for x in (x12, s):
            pj.update_state(x)
            pt.update_state(x)
            _close(pt.start_state.numpy(), pj.start_state, 1e-6)
            _close(pt.states.numpy(), pj.states, 0)
            assert pt.active == pj.active and pt.cfg.T == pj.cfg.T
        pj.save_progress(str(tmp_path / f"j{static}.npz"))
        pt.save_progress(str(tmp_path / f"t{static}.npz"))
        for static_load in (True, False):
            cj2, ct2 = _cfgs(static_horizon=static_load)
            qj, qt = jplan.Planner(s, e, cj2, dj), tplan.Planner(s, e, ct2, dt_, device="cpu")
            qj.load_progress(str(tmp_path / f"t{static}.npz"))
            qt.load_progress(str(tmp_path / f"j{static}.npz"))
            _close(qt.states.numpy(), qj.states, 0)
            assert qt.active == qj.active and qt.cfg.T == qj.cfg.T
            _close(qt.initial_accel.numpy(), qj.initial_accel, 0)


def test_planner_defaults_to_the_card():
    _, ct = _cfgs()
    s, e = _endpoints()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tplan.Planner(s, e, ct, lambda x: x[:, 0])
    # the two configs carry the same fields and defaults
    assert dataclasses.asdict(tplan.PlannerConfig()) == dataclasses.asdict(
        jplan.PlannerConfig())
