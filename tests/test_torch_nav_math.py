"""nerfnav_tpu_torch nav math, dynamics and A* against the JAX package, on
the CPU, on numpy-seeded inputs.

Rotation maps agree within 1e-6 (random, near-0 and near-pi inputs, where
the log map switches branch) and the forward-mode Jacobian of log(exp(v))
within 1e-4; the dynamics and its 12x12 forward-mode Jacobian within 1e-5;
the host numpy helpers up to float64 rounding (1e-12); and the three A*
searches (the port's native build, its Python golden and the JAX package's
Python golden) give identical paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from nerfnav_tpu.nav import dynamics as jdyn
from nerfnav_tpu.nav import math_utils as jmu
from nerfnav_tpu.nav.astar import astar_python as j_astar_python
from nerfnav_tpu_torch import native
from nerfnav_tpu_torch.nav import dynamics as tdyn
from nerfnav_tpu_torch.nav import math_utils as tmu
from nerfnav_tpu_torch.nav.astar import astar, astar_python

torch.set_num_threads(1)


def _rotvecs(kind, n=16, seed=0, max_angle=3.0):
    rng = np.random.default_rng(seed)
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    theta = {"random": rng.uniform(0.01, max_angle, (n, 1)),
             "near0": 10.0 ** rng.uniform(-9, -3, (n, 1)),
             "nearpi": np.pi - 10.0 ** rng.uniform(-6, -1, (n, 1))}[kind]
    return (ax * theta).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "near0", "nearpi"])
def test_rotation_maps(kind):
    v = _rotvecs(kind)
    Rj = np.asarray(jmu.vec_to_rot_matrix(jnp.asarray(v)))
    Rt = tmu.vec_to_rot_matrix(torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmu.skew_matrix(torch.as_tensor(v)).numpy(),
                               np.asarray(jmu.skew_matrix(jnp.asarray(v))), rtol=0, atol=0)
    back_j = np.asarray(jmu.rot_matrix_to_vec(jnp.asarray(Rj)))
    back_t = tmu.rot_matrix_to_vec(torch.tensor(Rj)).numpy()
    np.testing.assert_allclose(back_t, back_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["random", "near0"])
def test_rotation_map_jacobians(kind):
    """d log(exp(v)) / dv in forward mode against jax.jacfwd: finite at
    theta -> 0, where the Taylor branches take over."""
    jac_j = jax.jit(jax.jacfwd(lambda x: jmu.rot_matrix_to_vec(jmu.vec_to_rot_matrix(x))))
    for v in _rotvecs(kind, n=4, seed=1):
        jj = np.asarray(jac_j(jnp.asarray(v)))
        jt = jacfwd(lambda x: tmu.rot_matrix_to_vec(tmu.vec_to_rot_matrix(x)))(
            torch.as_tensor(v)).numpy()
        assert np.isfinite(jt).all()
        np.testing.assert_allclose(jt, jj, rtol=0, atol=1e-4)
    z = torch.zeros(3)
    jt = jacfwd(lambda x: tmu.rot_matrix_to_vec(tmu.vec_to_rot_matrix(x)))(z).numpy()
    np.testing.assert_allclose(jt, np.eye(3), atol=1e-3)


def test_mahalanobis_and_rot_x():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 3))
    sig = (a @ a.T + np.eye(3)).astype(np.float32)
    x, mu = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    want = float(jmu.mahalanobis(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(sig)))
    got = float(tmu.mahalanobis(*map(torch.as_tensor, (x, mu, sig))))
    assert abs(got - want) <= 1e-5 * abs(want)
    np.testing.assert_allclose(tmu.rot_x(0.7).numpy(), np.asarray(jmu.rot_x(0.7)), atol=1e-7)


def test_nearest_pd_and_se3_err():
    rng = np.random.default_rng(3)
    for _ in range(5):
        a = rng.normal(size=(12, 12))
        np.testing.assert_allclose(tmu.nearest_pd(a), jmu.nearest_pd(a), rtol=0, atol=1e-12)
        assert tmu.is_pd(tmu.nearest_pd(a)) and not tmu.is_pd(-np.eye(3))
    bad = np.full((4, 4), np.nan)
    np.testing.assert_array_equal(tmu.nearest_pd(bad), jmu.nearest_pd(bad))
    p1, p2 = np.eye(4), np.eye(4)
    p2[:3, :3] = np.asarray(jmu.vec_to_rot_matrix(jnp.asarray([0.1, -0.2, 0.3])))
    p2[:3, 3] = [0.5, 0.0, -0.1]
    assert tmu.calc_se3_err(p2, p1) == jmu.calc_se3_err(p2, p1)


def _states(seed, n=6):
    """Flight states with attitudes up to 2 rad: nearer pi the log map's
    1 / sin(theta) makes float32 Jacobians of either package stray ~1e-5
    from the float64 one."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 12), np.float32)
    x[:, 0:3] = rng.normal(size=(n, 3))
    x[:, 3:6] = rng.normal(size=(n, 3)) * 0.5
    x[:, 6:9] = _rotvecs("random", n, seed, max_angle=2.0)
    x[:, 9:12] = rng.normal(size=(n, 3))
    a = np.concatenate([rng.uniform(5, 15, (n, 1)), rng.normal(size=(n, 3)) * 0.01],
                       -1).astype(np.float32)
    return x, a


def test_dynamics_and_jacobian():
    cfg_j, cfg_t = jdyn.DynamicsConfig(dt=0.1), tdyn.DynamicsConfig(dt=0.1)
    step_j = jax.jit(lambda s, a: jdyn.drone_dynamics(s, a, cfg_j))
    jac_j = jax.jit(jax.jacfwd(lambda s, a: jdyn.drone_dynamics(s, a, cfg_j)))
    xs, acts = _states(4)
    for x, a in zip(xs, acts):
        want = np.asarray(step_j(jnp.asarray(x), jnp.asarray(a)))
        got = tdyn.drone_dynamics(torch.as_tensor(x), torch.as_tensor(a), cfg_t).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        Aj = np.asarray(jac_j(jnp.asarray(x), jnp.asarray(a)))
        At = jacfwd(lambda s: tdyn.drone_dynamics(s, torch.as_tensor(a), cfg_t))(
            torch.as_tensor(x)).numpy()
        assert At.shape == (12, 12)
        np.testing.assert_allclose(At, Aj, rtol=0, atol=1e-5)


def test_simulator_and_next_rotation():
    x0 = np.zeros(18, np.float32)
    x0[6:15] = np.eye(3).reshape(-1)
    sj = jdyn.Simulator(x0, jdyn.DynamicsConfig())
    st = tdyn.Simulator(x0, tdyn.DynamicsConfig(), device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(5):
        a = np.concatenate([[10.5], rng.normal(size=3) * 1e-3]).astype(np.float32)
        np.testing.assert_allclose(st.advance(a), sj.advance(a), rtol=0, atol=1e-5)
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(st.body_to_world(pts), sj.body_to_world(pts), atol=1e-5)
    R = np.asarray(jmu.vec_to_rot_matrix(jnp.asarray([0.3, 0.1, -0.2])))
    w = np.asarray([0.5, -1.0, 2.0], np.float32)
    np.testing.assert_allclose(
        tdyn.next_rotation(torch.as_tensor(R), torch.as_tensor(w), 0.1).numpy(),
        np.asarray(jdyn.next_rotation(jnp.asarray(R), jnp.asarray(w), 0.1)), atol=1e-6)


@pytest.mark.parametrize("density", [0.15, 0.3, 0.4])
def test_astar_paths_identical(density):
    """Native, port-Python and JAX-Python A* return the same path (not just
    the same length): the native frontier breaks ties as the Python heap."""
    rng = np.random.default_rng(int(density * 100))
    for shape in ((12, 12, 12), (20, 20, 20), (16, 9, 5)):
        occ = rng.random(shape) < density
        s, g = (0, 0, 0), tuple(d - 1 for d in shape)
        occ[s] = occ[g] = False
        want = j_astar_python(occ, s, g)
        assert astar_python(occ, s, g) == want
        assert astar(occ, s, g) == want
    assert native._lib is not None  # astar ran the native build


def test_astar_edges():
    occ = np.zeros((8, 8, 8), bool)
    occ[4] = True
    assert astar(occ, (0, 0, 0), (7, 0, 0)) is None
    assert astar_python(occ, (0, 0, 0), (7, 0, 0)) is None
    occ[0, 0, 0] = True
    occ[4] = False
    for fn in (astar, astar_python):
        with pytest.raises(ValueError):
            fn(occ, (0, 0, 0), (3, 3, 3))
    with pytest.raises(ValueError):
        astar(occ, (1, 1, 1), (8, 0, 0))
