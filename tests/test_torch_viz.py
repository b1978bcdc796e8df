"""nerfnav_tpu_torch's nav plots (nav/viz.py) against the JAX package's, on
the CPU on matplotlib's Agg backend: tests/test_viz.py's four cases on the
port; QuadPlot's line data equal to JAX's for one states dict, and within
the planner's parity tolerance (1e-5 of the largest coordinate) from a port
Planner and a JAX Planner on the same waypoints; tensors (that require grad)
taken as they come; the triptych's panels equal; and `render_viz` writing
the triptych of one GN update of the pose filter.
"""

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from nerfnav_tpu.nav import planner as jplan  # noqa: E402
from nerfnav_tpu.nav import viz as jviz  # noqa: E402
from nerfnav_tpu_torch.data import rays as trays  # noqa: E402
from nerfnav_tpu_torch.data import synthetic as tsyn  # noqa: E402
from nerfnav_tpu_torch.models import renderer as trend  # noqa: E402
from nerfnav_tpu_torch.nav import agent as tagent  # noqa: E402
from nerfnav_tpu_torch.nav import estimator as test_  # noqa: E402
from nerfnav_tpu_torch.nav import planner as tplan  # noqa: E402
from nerfnav_tpu_torch.nav import viz as tviz  # noqa: E402
from nerfnav_tpu_torch.nav.dynamics import DynamicsConfig  # noqa: E402

torch.set_num_threads(1)


def make_state(pos):
    s = np.zeros(18, np.float32)
    s[0:3] = pos
    s[6:15] = np.eye(3).reshape(-1)
    return s


def _lines(qp):
    """Every line of the map axis: (xyz (3, n), colour, marker)."""
    return [(np.asarray(line.get_data_3d(), np.float64), line.get_color(), line.get_marker())
            for line in qp.ax_map.lines]


def _states(seed=0, n=8):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n - 1, 3)) * 0.3
    rot = np.stack([np.linalg.qr(m)[0] for m in rng.normal(size=(n - 1, 3, 3))])
    return {"pos": np.cumsum(a, 0).astype(np.float32).tolist() + [[0.0, 0.0, 0.0]],
            "rot": rot.astype(np.float32)}


# ---------------------------------------------------- tests/test_viz.py's cases
def test_quadplot_from_planner(tmp_path):
    cfg = tplan.PlannerConfig(T=6, dt=0.1)
    planner = tplan.Planner(make_state((-0.5, 0, 0.2)), make_state((0.5, 0, 0.2)), cfg,
                            density_fn=lambda x: torch.zeros(x.shape[0]), device="cpu")
    qp = tviz.QuadPlot()
    qp.trajectory(planner, color="g")
    qp.plot_data(np.arange(5), np.arange(5) ** 2, label="cost")
    qp.plot_data(np.arange(5), np.arange(5), right=True)
    out = qp.save(tmp_path / "traj.png")
    qp.close()
    assert out.exists() and out.stat().st_size > 0


def test_quadplot_accepts_states_dict(tmp_path):
    out = {"pos": np.linspace([0, 0, 0], [1, 1, 1], 8),
           "rot": np.broadcast_to(np.eye(3), (7, 3, 3))}
    qp = tviz.QuadPlot(body_points=np.zeros((4, 3)))
    qp.trajectory(out, color="b", show_cloud=True)
    p = qp.save(tmp_path / "dict.png")
    qp.close()
    assert p.exists()


def test_estimator_triptych(tmp_path):
    rng = np.random.default_rng(0)
    gt = rng.random((32, 48, 3)).astype(np.float32)
    render = rng.random((32, 48, 3)).astype(np.float32)
    poi = np.array([[5, 7], [20, 15], [47, 31]])  # [x, y]
    path = tmp_path / "trip.png"
    tviz.estimator_triptych(gt, render, poi, title="step 3", path=path)
    assert path.exists() and path.stat().st_size > 0


def test_triptych_marks_keypoints_green():
    gt = np.zeros((16, 16, 3), np.float32)
    fig = tviz.estimator_triptych(gt, gt.copy(), np.array([[4, 9]]))
    img = fig.axes[0].images[0].get_array()
    assert np.allclose(img[9, 4], [0, 1, 0])
    plt.close(fig)


# --------------------------------------------------------------- against JAX
@pytest.mark.parametrize("color,cloud", [("g", True), (["r", "g", "b", "c", "m", "y", "k"], True),
                                         ("b", False)])
def test_quadplot_lines_match_jax(color, cloud):
    """The same states dict through both QuadPlots: every line's xyz,
    colour and marker equal."""
    states = _states()
    body = np.random.default_rng(1).normal(size=(6, 3)) * 0.05
    got, want = tviz.QuadPlot(body_points=body), jviz.QuadPlot(body_points=body)
    got.trajectory(states, color=color, show_cloud=cloud)
    want.trajectory(states, color=color, show_cloud=cloud)
    lg, lw = _lines(got), _lines(want)
    assert len(lg) == len(lw) == 1 + 7 * cloud + 21
    for (xg, cg, mg), (xw, cw, mw) in zip(lg, lw):
        np.testing.assert_array_equal(xg, xw)
        assert (cg, mg) == (cw, mw)
    got.close()
    want.close()


def test_quadplot_takes_tensors():
    """A states dict of tensors that require grad plots as its numpy copy
    does, and plot_data takes tensors."""
    states = _states(seed=2)
    tensors = {k: torch.as_tensor(np.asarray(v)).requires_grad_() for k, v in states.items()}
    a, b = tviz.QuadPlot(), tviz.QuadPlot()
    a.trajectory(tensors)
    b.trajectory(states)
    for (xa, ca, ma), (xb, cb, mb) in zip(_lines(a), _lines(b)):
        np.testing.assert_array_equal(xa, xb)
        assert (ca, ma) == (cb, mb)
    a.plot_data(torch.arange(4.0), torch.arange(4.0).requires_grad_() ** 2)
    np.testing.assert_array_equal(a.ax_graph.lines[0].get_ydata(), [0, 1, 4, 9])
    a.close()
    b.close()


def test_quadplot_planners_match_jax(monkeypatch):
    """A port Planner and a JAX Planner on the same waypoints (the port's
    requiring grad, as while it learns) plot the same lines within 1e-5 of
    the largest coordinate: their rollouts agree to that
    (tests/test_torch_nav_planner.py). The JAX rollout runs jitted: op by
    op it compiles for seconds."""
    monkeypatch.setattr(jplan, "calc_everything",
                        jax.jit(jplan.calc_everything, static_argnames=("cfg", "active")))
    cfg = dict(T=6, dt=0.1, body_nbins=(3, 3, 2))
    s, e = make_state((0.8, -0.7, 0.1)), make_state((-0.7, 0.75, 0.15))
    w = np.random.default_rng(3).normal(size=(6, 4)).astype(np.float32) * 0.3
    pj = jplan.Planner(s, e, jplan.PlannerConfig(**cfg), lambda x: jnp.zeros(x.shape[0]))
    pt = tplan.Planner(s, e, tplan.PlannerConfig(**cfg), lambda x: torch.zeros(x.shape[0]),
                       device="cpu")
    pj.states = jnp.asarray(w)
    pt.states = torch.as_tensor(w).requires_grad_()
    got, want = tviz.QuadPlot(), jviz.QuadPlot()
    got.trajectory(pt, color="r")
    want.trajectory(pj, color="r")
    lg, lw = _lines(got), _lines(want)
    assert len(lg) == len(lw) > 20
    scale = max(np.abs(x).max() for x, _, _ in lw)
    for (xg, cg, mg), (xw, cw, mw) in zip(lg, lw):
        assert xg.shape == xw.shape and (cg, mg) == (cw, mw)
        assert np.abs(xg - xw).max() <= 1e-5 * scale
    got.close()
    want.close()


def test_triptych_matches_jax():
    """Both triptychs from the same images (uint8, so scaled by 1/255) and
    keypoints, some off the image and clipped: the three panels equal; tensor
    inputs give the same panels."""
    rng = np.random.default_rng(4)
    gt = (rng.random((20, 28, 3)) * 255).astype(np.uint8)
    render = rng.random((20, 28, 3)).astype(np.float32)
    poi = np.array([[3, 4], [27, 19], [40, -2], [10, 11]])
    figs = [jviz.estimator_triptych(gt, render, poi, title="t"),
            tviz.estimator_triptych(gt, render, poi, title="t"),
            tviz.estimator_triptych(torch.as_tensor(gt), torch.as_tensor(render),
                                    torch.as_tensor(poi), title="t")]
    panels = [[np.asarray(ax.images[0].get_array()) for ax in f.axes] for f in figs]
    for got in panels[1:]:
        for g, w in zip(got, panels[0]):
            np.testing.assert_array_equal(g, w)
    assert figs[1]._suptitle.get_text() == figs[0]._suptitle.get_text() == "t"
    for f in figs:
        plt.close(f)


# --------------------------------------------------------------- render_viz
def test_render_viz_writes_the_triptych(tmp_path, monkeypatch):
    """EstimatorConfig(render_viz=True) with a workspace: one GN update at
    the CPU tests' size (a 32x32 observation of the textured sphere) writes
    estimator_data/viz_0001.png beside step_0001.json; the triptych's
    render is the filter's render at the posterior pose and its title the
    update's errors."""
    import cv2

    hw, focal = 32, 32.0
    x0 = np.zeros(12, np.float32)
    x0[0:3] = [0.0, -1.6, 0.0]
    x0[6:9] = [0.0, 0.0, np.pi / 2]
    field = tsyn.textured_sphere_field()
    rcfg = trend.RenderConfig(num_steps=32, upsample_steps=0, min_near=0.05)
    intr = torch.as_tensor(np.asarray([focal, focal, hw / 2, hw / 2], np.float32))
    agent = tagent.Agent(x0, tagent.AgentConfig(dyn=DynamicsConfig(dt=0.2), H=hw, W=hw,
                                                focal=focal), field=field, device="cpu")
    pose_gt = tagent.body_state_to_camera_pose(torch.as_tensor(x0)).numpy()
    obs = agent.get_img(pose_gt)
    cfg = test_.EstimatorConfig(lr=5e-3, n_iters=4, gn_iters=4, gn_jac_batch=32, batch_size=64,
                                pool_size=256, render_viz=True)
    est = test_.Estimator(cfg, DynamicsConfig(dt=0.2),
                          lambda o, d: trend.render_rays(field, rcfg, o, d, bg_color=1.0),
                          lambda p: trays.get_all_rays(p, intr, hw, hw),
                          tagent.body_state_to_camera_pose, workspace=str(tmp_path),
                          get_rays_at_fn=lambda p, i: trays.get_rays_at(p, intr, hw, i),
                          device="cpu")
    x = x0.copy()
    x[0:3] += [0.02, -0.01, 0.015]
    est.set_initial_state(x)
    seen = []
    real = tviz.estimator_triptych
    monkeypatch.setattr(tviz, "estimator_triptych",
                        lambda *a, **k: seen.append((a, k)) or real(*a, **k))
    post = est.estimate_state(obs, pose_gt, np.asarray([10.0, 0, 0, 0], np.float32))
    assert np.isfinite(post).all()
    path = tmp_path / "estimator_data" / "viz_0001.png"
    assert path.exists() and (tmp_path / "estimator_data" / "step_0001.json").exists()
    assert cv2.imread(str(path)) is not None
    (img, render, poi), kw = seen[0]
    np.testing.assert_array_equal(img, obs.astype(np.float32) / 255.0)
    want = est.render_from_pose(est.state_to_pose(torch.as_tensor(post)).numpy(), hw, hw)
    np.testing.assert_allclose(render, want, rtol=0, atol=1e-6)
    assert len(poi) >= 3 and kw["title"].startswith("Time step: 1. Trans. error: ")
    assert kw["path"] == str(path)
