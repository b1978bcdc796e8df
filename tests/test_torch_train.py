"""nerfnav_tpu_torch training vs the JAX package's, on the CPU: Adam and its
schedule, one train step, the host schedule and checkpoints both ways.

One step runs from the same params, occupancy, image and draws (split from
the JAX step's key as the step splits it). Both steps shade the port's
keyed march, which tests/test_torch_march.py holds against the JAX march run
op by op: the jitted JAX step would otherwise let XLA contract multiply-adds
into FMAs and move a sample across a cell boundary. The JAX step returns no
gradients; Adam's first moment after the first step is 0.1 g in both, so the
test holds the gradients through it. Tolerances: the xla fp32 field within
1e-5 (of each tensor's largest entry), the fused field within 2e-2 (the JAX
side runs the Pallas kernel in interpret mode). With eps = 1e-15 Adam's
first step is lr sign(g), so a gradient near 0 can take either sign: params
after the step are held (within 1e-6) only where g = 0 or |g| > 1e-6 max|g|
for the fp32 field and 2e-2 max|g| for the fused one, and the test counts the
entries it leaves out.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfnav_tpu.models import network as jnet
from nerfnav_tpu.models import renderer as jrend
from nerfnav_tpu.models.occupancy import OccupancyConfig as JOccCfg
from nerfnav_tpu.ops import marching as jm
from nerfnav_tpu.training import Trainer as JTrainer, TrainerOptions as JOpts
from nerfnav_tpu_torch.data import rays as trays
from nerfnav_tpu_torch.models import network as tnet
from nerfnav_tpu_torch.models import renderer as trend
from nerfnav_tpu_torch.models.occupancy import OccupancyConfig as TOccCfg
from nerfnav_tpu_torch.ops import marching as tm
from nerfnav_tpu_torch.training import trainer as ttrain
from nerfnav_tpu_torch.training.checkpoint import occupancy_from_numpy, params_from_numpy
from nerfnav_tpu_torch.utils.mesh import extract_geometry
from test_torch_march import shell_occupancy

torch.set_num_threads(1)

HW = 24
N_RAYS = 256


class ArrayDataset:
    """An in-memory dataset: what Trainer.train reads."""

    def __init__(self, poses, images, intrinsics):
        self.poses, self.images, self.intrinsics = poses, images, intrinsics
        self.H, self.W = images.shape[1:3]

    def __len__(self):
        return len(self.poses)

    def as_arrays(self):
        return {"poses": self.poses, "images": self.images, "intrinsics": self.intrinsics}


def _dataset(n=2, channels=4, seed=0):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        th = 0.4 * i
        c, s = np.cos(th), np.sin(th)
        poses[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        poses[i, :3, 3] = [-3.0 * s, 0.05, -3.0 * c]
    images = rng.random((n, HW, HW, channels)).astype(np.float32)
    intr = np.asarray([HW * 1.2, HW * 1.2, HW / 2, HW / 2], np.float32)
    return ArrayDataset(poses, images, intr)


def _net_kw(**kw):
    base = dict(bound=2.0, grid_levels=2, grid_level_dim=8, grid_log2_hashmap_size=10,
                grid_max_resolution=32, grid_layout="cell", density_scale=10.0)
    base.update(kw)
    return base


MARCH = dict(bound=2.0, grid_size=32, max_steps=256, samples_per_ray=16, min_near=0.05)
OCC = dict(bound=2.0, grid_size=32, update_chunk=8192, density_thresh=2.0, min_near=0.05)


def _trainers(tmp_path, net_kw=None, **opt_kw):
    """A JAX Trainer and its port on the same params and shell occupancy."""
    net_kw = net_kw or _net_kw()
    pj = jnet.init_network(jax.random.PRNGKey(0), jnet.NetworkConfig(**net_kw))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    occ, _ = shell_occupancy(32, 2)
    okw = dict(num_rays=N_RAYS, iters=200, use_checkpoint="scratch", **opt_kw)
    tj = JTrainer(jnet.NetworkConfig(**net_kw), jrend.RenderConfig(),
                  JOpts(name="j", workspace=str(tmp_path / "j"), **okw), params=pj,
                  occupancy_cfg=JOccCfg(**OCC), march_cfg=jm.MarchConfig(**MARCH))
    tt = ttrain.Trainer(tnet.NetworkConfig(**net_kw), trend.RenderConfig(),
                        ttrain.TrainerOptions(name="t", workspace=str(tmp_path / "t"), **okw),
                        params=pt, occupancy_cfg=TOccCfg(**OCC),
                        march_cfg=tm.MarchConfig(**MARCH), device="cpu")
    tj.state = tj._init_state(2)
    st = dict(tj.state.occupancy)
    st.update({k: jnp.asarray(v) for k, v in occ.items()})
    tj.state = tj.state._replace(occupancy=st)
    tt.set_occupancy({**tt.occupancy, **occupancy_from_numpy(occ, device="cpu")})
    if tt.opt.error_map:
        tt.state.error_maps = torch.full((2, 128 * 128), 0.1)
    return tj, tt


def _draws_from_key(key, emap, idx, H, W):
    """The port's StepDraws from the JAX step's key, split as its step and
    march split it."""
    k_ray, k_perturb, k_bg = jax.random.split(key, 3)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    if emap is None:
        rays = trays.RayDraws(inds=t(jax.random.randint(k_ray, (N_RAYS,), 0, H * W)).long())
    else:
        k1, k2 = jax.random.split(k_ray)
        rays = trays.RayDraws(
            bins=t(jax.random.categorical(k1, jnp.log(jnp.asarray(emap) + 1e-8),
                                          shape=(N_RAYS,))).long(),
            jitter=t(jax.random.uniform(k2, (N_RAYS, 2))))
    k_start, k_phase = jax.random.split(k_perturb)
    return ttrain.StepDraws(
        idx=idx, rays=rays, bg=t(jax.random.uniform(k_bg, (N_RAYS, 3))),
        march=tm.MarchKey(u=t(jax.random.uniform(k_start, (N_RAYS,))),
                          phase=t(jax.random.randint(k_phase, (N_RAYS, 1), 0, 2**30)).long()))


def _patch_march(monkeypatch, tt, arrays, draws):
    """Let the JAX step shade the port's march of these draws."""
    H, W = arrays["images"].shape[1:3]
    emap = None if tt.state.error_maps is None else tt.state.error_maps[draws.idx]
    rays = trays.get_rays(arrays["poses"][draws.idx], arrays["intrinsics"], H, W,
                          draws.rays, emap)
    m = tm.march(rays["rays_o"], rays["rays_d"], tt.occupancy, tt._train_march_cfg(),
                 key=draws.march)
    monkeypatch.setattr(jm, "march", lambda *a, **k: {
        name: jnp.asarray(v.numpy()) for name, v in m.items()})
    return int(m["valid"].sum())


def _grads_close(gt, gj, rel):
    for a, b in zip(gt, gj):
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


@pytest.mark.parametrize("backend,budget", [("xla", None), ("xla", 1024), ("fused", None)])
def test_train_step_matches(backend, budget, tmp_path, monkeypatch):
    """One step: loss, per-ray loss (through the error-map EMA), the valid
    count (through the mean-count EMA), gradients and the params and EMA
    after Adam; dense and, at a budget below the valid count, packed."""
    net_kw = _net_kw(mlp_backend=backend)
    tj, tt = _trainers(tmp_path, net_kw, error_map=True, dt_anneal=((0.0, 2),))
    ds = _dataset()
    H, W, C = ds.images.shape[1:]
    for tr in (tj, tt):
        tr._mean_count_host = 0.0 if budget is None else budget / 1.15 - 1.0
    assert tt._current_budget() == tj._current_budget() == budget
    arrays_t = tt._device_arrays(ds)
    key = jax.random.PRNGKey(5)
    draws = _draws_from_key(key, np.asarray(tj.state.error_maps[1]), 1, H, W)
    n_valid = _patch_march(monkeypatch, tt, arrays_t, draws)
    assert n_valid > (budget or 0)
    step_j = tj._build_train_step(H, W, C, tj._dt_mult(), budget)
    sj, loss_j = step_j(tj.state, {k: jnp.asarray(v) for k, v in ds.as_arrays().items()},
                        jnp.asarray(1), key)
    p0 = [t.detach().clone() for t in ttrain._leaves(tt.params)]
    out = tt.loss_and_grads(tt.state, arrays_t, draws)
    tt.apply(tt.state, out, draws.idx, H, W)

    tol = 1e-5 if backend == "xla" else 2e-2
    np.testing.assert_allclose(float(out.loss), float(loss_j), rtol=tol)
    assert int(out.n_samples) == n_valid
    np.testing.assert_allclose(float(tt.state.mean_count), float(sj.mean_count), rtol=1e-6)
    np.testing.assert_allclose(tt.state.error_maps.numpy(), np.asarray(sj.error_maps),
                               rtol=0, atol=tol * 0.1)
    mu_j = [np.asarray(m) for m in jax.tree_util.tree_leaves(sj.opt_state[0].mu)]
    opt = tt.state.optimizer
    _grads_close([opt.state[p]["exp_avg"].numpy() for p in ttrain._leaves(tt.params)],
                 mu_j, tol)
    _grads_close([0.1 * g.numpy() for g in out.grads], mu_j, tol)
    held = left_out = 0
    for p, p_0, e, pj_, ej, m in zip(
            ttrain._leaves(tt.params), p0, ttrain._leaves(tt.state.ema_params),
            jax.tree_util.tree_leaves(sj.params), jax.tree_util.tree_leaves(sj.ema_params),
            mu_j):
        # zero gradients (rows no sample touched) must leave params unchanged
        keep = (np.abs(m) > (1e-6 if backend == "xla" else 2e-2) * np.abs(m).max()) | (m == 0)
        np.testing.assert_allclose(p.detach().numpy()[keep], np.asarray(pj_)[keep],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(e.numpy()[keep], np.asarray(ej)[keep], rtol=0, atol=1e-6)
        assert not torch.equal(p.detach(), p_0)
        held += int(keep.sum())
        left_out += int((~keep).sum())
    print(f"{backend} budget {budget}: params held at {held} entries, "
          f"{left_out} small gradients left out")
    assert held > left_out, (held, left_out)
    assert tt.global_step == 1


@pytest.mark.parametrize("upsample", [0, 8])
def test_dense_train_step_matches(upsample, tmp_path):
    """The dense train step (no occupancy grid: render_rays over 16 jittered
    samples a ray, with upsample > 0 also importance samples) from the JAX
    step's key, split as its step and render_rays split it: the loss, the
    per-ray loss (through the error-map EMA) and the gradients (through
    Adam's first moment) within 1e-5 of each tensor's largest entry, xla
    fp32 field. No valid count: the mean-count EMA stays unset."""
    net_kw = _net_kw()
    rkw = dict(num_steps=16, upsample_steps=upsample, min_near=0.05)
    okw = dict(num_rays=N_RAYS, iters=200, use_checkpoint="scratch", error_map=True)
    pj = jnet.init_network(jax.random.PRNGKey(0), jnet.NetworkConfig(**net_kw))
    tj = JTrainer(jnet.NetworkConfig(**net_kw), jrend.RenderConfig(**rkw),
                  JOpts(name="j", workspace=str(tmp_path / "j"), **okw), params=pj)
    tj.state = tj._init_state(2)
    tt = ttrain.Trainer(tnet.NetworkConfig(**net_kw), trend.RenderConfig(**rkw),
                        ttrain.TrainerOptions(name="t", workspace=str(tmp_path / "t"), **okw),
                        params=params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                                 device="cpu"), device="cpu")
    tt.state.error_maps = torch.full((2, 128 * 128), 0.1)
    ds = _dataset()
    H, W, C = ds.images.shape[1:]
    key = jax.random.PRNGKey(9)
    k_ray, k_perturb, k_bg = jax.random.split(key, 3)
    k_up, k_jit = jax.random.split(k_perturb)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    emap = jnp.asarray(tj.state.error_maps[1])
    k1, k2 = jax.random.split(k_ray)
    draws = ttrain.StepDraws(
        idx=1, rays=trays.RayDraws(
            bins=t(jax.random.categorical(k1, jnp.log(emap + 1e-8), shape=(N_RAYS,))).long(),
            jitter=t(jax.random.uniform(k2, (N_RAYS, 2)))),
        bg=t(jax.random.uniform(k_bg, (N_RAYS, 3))),
        jitter=t(jax.random.uniform(k_jit, (N_RAYS, 16))),
        u=(t(jax.random.uniform(jax.random.split(k_up)[1], (N_RAYS, upsample)))
           if upsample else None))
    assert tt.draw_step(tt.state, 0, H, W).jitter.shape == (N_RAYS, 16)
    step_j = tj._build_train_step(H, W, C, 1, None)
    sj, loss_j = step_j(tj.state, {k: jnp.asarray(v) for k, v in ds.as_arrays().items()},
                        jnp.asarray(1), key)
    arrays_t = tt._device_arrays(ds)
    out = tt.loss_and_grads(tt.state, arrays_t, draws)
    tt.apply(tt.state, out, draws.idx, H, W)
    np.testing.assert_allclose(float(out.loss), float(loss_j), rtol=1e-5)
    assert out.n_samples is None and tt.state.mean_count is None
    np.testing.assert_allclose(tt.state.error_maps.numpy(), np.asarray(sj.error_maps),
                               rtol=0, atol=1e-6)
    mu_j = [np.asarray(m) for m in jax.tree_util.tree_leaves(sj.opt_state[0].mu)]
    _grads_close([0.1 * g.numpy() for g in out.grads], mu_j, 1e-5)


def test_adam_and_schedule_match_optax(tmp_path):
    """Three Adam steps from the same numpy gradients against the JAX
    Trainer's optax chain (schedule at the pre-increment count): params
    within 1e-6, and the optax-shaped state: count exact, mu and nu within
    1e-6 of each tensor's largest entry (torch's Adam updates mu by lerp, optax
    by b1 mu + (1 - b1) g: the roundings differ where steps cancel)."""
    tj, tt = _trainers(tmp_path, lr_iters=7)
    rng = np.random.default_rng(1)
    pj = tj.state.params
    opt_state = tj.optimizer.init(pj)
    leaves_j, treedef = jax.tree_util.tree_flatten(pj)
    for _ in range(3):
        g = [rng.normal(scale=rng.uniform(1e-4, 1.0), size=np.shape(p)).astype(np.float32)
             for p in leaves_j]
        updates, opt_state = tj.optimizer.update(
            jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in g]), opt_state)
        pj = jax.tree_util.tree_map(lambda p, u: p + u, pj, updates)
        tt.apply(tt.state, ttrain.StepOut(None, None, None, [torch.as_tensor(x) for x in g],
                                          None), 0, HW, HW)
        leaves_j = jax.tree_util.tree_leaves(pj)
    for a, b in zip(ttrain._leaves(tt.params), leaves_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)
    adam, sched = ttrain.ckpt_lib.adam_to_optax(tt.state.optimizer, tt.params)
    assert int(adam.count) == int(opt_state[0].count) == int(sched.count) == 3
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves({k: getattr(adam, name)[k] for k in adam.mu}),
                        jax.tree_util.tree_leaves(getattr(opt_state[0], name))):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6 * np.abs(b).max())


def test_host_schedule_matches(tmp_path):
    """_dt_mult, _current_budget and _steps_to_phase_boundary equal the JAX
    Trainer's at every one of 40 steps, across two occupancy updates (every
    16 steps, where the mean-count mirror moves) and the dt-anneal
    boundaries at 10, 20 and 40."""
    tj, tt = _trainers(tmp_path)
    counts = {0: 0.0, 16: 1500.0, 32: 3000.0}
    budgets = set()
    for step in range(40):
        tj.global_step = step
        tt.state.global_step = step
        if step in counts:
            tj._mean_count_host = tt._mean_count_host = counts[step]
        assert tt._dt_mult() == tj._dt_mult()
        assert tt._current_budget() == tj._current_budget()
        budgets.add(tt._current_budget())
        assert tt._steps_to_phase_boundary() == tj._steps_to_phase_boundary()
        assert tt._train_march_cfg().max_steps == max(MARCH["max_steps"] // tj._dt_mult(),
                                                      8)
    assert budgets == {None, 2048}


def _assert_trees_equal(tree_t, tree_j):
    for a, b in zip(jax.tree_util.tree_leaves(tree_t), jax.tree_util.tree_leaves(tree_j)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))


def _trained(tt, steps=2):
    ds = _dataset()
    arrays = tt._device_arrays(ds)
    for i in range(steps):
        tt.train_step(tt.state, arrays, tt.draw_step(tt.state, i % 2, HW, HW))
    return ds, arrays


def test_checkpoint_port_to_jax(tmp_path):
    """The port writes after two steps; JAX's load_checkpoint and
    _maybe_resume read params, EMA, Adam state (count, mu, nu), error maps
    and occupancy exactly (uint32 block words as uint32)."""
    tj, tt = _trainers(tmp_path, error_map=True)
    _trained(tt)
    tt.epoch = 1
    tt.save_checkpoint(full=True)
    tj.opt.use_checkpoint = "latest"
    tj.ckpt_dir = tt.ckpt_dir
    tj.opt.name = "t"
    tj._maybe_resume()
    assert (tj.epoch, tj.global_step) == (1, 2)
    st = tj.state
    _assert_trees_equal({k: tt.params[k] for k in tt.params}, st.params)
    _assert_trees_equal(tt.state.ema_params, st.ema_params)
    adam, _ = ttrain.ckpt_lib.adam_to_optax(tt.state.optimizer, tt.params)
    assert int(st.opt_state[0].count) == int(st.opt_state[1].count) == 2
    _assert_trees_equal(adam.mu, st.opt_state[0].mu)
    _assert_trees_equal(adam.nu, st.opt_state[0].nu)
    np.testing.assert_array_equal(np.asarray(st.error_maps), tt.state.error_maps.numpy())
    for k, v in tt.occupancy.items():
        got = np.asarray(st.occupancy[k])
        assert got.dtype == (np.uint32 if k.startswith("blocks") else got.dtype)
        np.testing.assert_array_equal(got.astype(np.int64), v.numpy().astype(np.int64))


def test_checkpoint_jax_to_port_and_resume(tmp_path):
    """JAX writes a full checkpoint and the port resumes it exactly; then a
    resumed port trainer takes the same next step as the one that wrote."""
    tj, tt = _trainers(tmp_path)
    pj = tj.state.params
    opt_state = tj.optimizer.init(pj)
    g = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.3), pj)
    updates, opt_state = tj.optimizer.update(g, opt_state)
    tj.state = tj.state._replace(params=jax.tree_util.tree_map(jnp.add, pj, updates),
                                 opt_state=opt_state)
    tj.epoch, tj.global_step = 3, 1
    tj.save_checkpoint(full=True)
    tt.opt.use_checkpoint = str(tmp_path / "j" / "checkpoints" / "j_ep0003.npz")
    tt._maybe_resume()
    assert (tt.epoch, tt.global_step) == (3, 1)
    _assert_trees_equal(tt.params, tj.state.params)
    _assert_trees_equal(tt.state.ema_params, tj.state.ema_params)
    adam, _ = ttrain.ckpt_lib.adam_to_optax(tt.state.optimizer, tt.params)
    assert int(adam.count) == 1
    _assert_trees_equal(adam.nu, opt_state[0].nu)
    _assert_trees_equal(tt.occupancy, tj.state.occupancy)

    # the port's own round trip: the resumed trainer's next step equals the
    # uninterrupted one's
    _, arrays = _trained(tt)
    tt.epoch = 4
    tt.save_checkpoint(full=True)
    tt._mean_count_host = 1.0  # a budget both take
    draws = tt.draw_step(tt.state, 0, HW, HW)
    _, tt2 = _trainers(tmp_path / "b")
    tt2.opt.use_checkpoint = "latest"
    tt2.ckpt_dir = tt.ckpt_dir
    tt2.opt.name = "t"
    tt2._maybe_resume()
    tt2._mean_count_host = tt._mean_count_host
    tt2.state.mean_count = tt.state.mean_count.clone()
    for tr in (tt, tt2):
        tr.train_step(tr.state, arrays, draws)
    _assert_trees_equal(tt.params, {k: [t.detach() for t in v] for k, v in tt2.params.items()})
    _assert_trees_equal(tt.state.ema_params, tt2.state.ema_params)


def test_train_loop_and_evaluate(tmp_path):
    """Trainer.train on an in-memory dataset: occupancy sweeps at steps 0, 8
    and 16 (full, then partial after n_full_updates), the budget picked from
    the mean count, a checkpoint per epoch, a finite falling-or-flat loss;
    evaluate gives a PSNR with the EMA params. scan_steps runs the same
    number of steps. test writes each frame and its depth map, save_mesh a
    PLY of the field's surface."""
    _, tt = _trainers(tmp_path, update_extra_interval=8, error_map=True)
    tt.occupancy_cfg = dataclasses.replace(tt.occupancy_cfg, n_full_updates=2)
    tt.set_occupancy(tt.state.occupancy)
    ds = _dataset()
    v0 = tt._occ_version
    tt.train(ds, max_epochs=1, steps_per_epoch=20)
    assert tt.global_step == 20 and tt.epoch == 1
    assert int(tt.occupancy["iter_density"]) == 3 and tt._occ_version >= v0 + 4
    assert tt._mean_count_host > 0 and np.isfinite(tt.stats["loss"][-1])
    assert (tt.state.error_maps != 0.1).any()
    assert ttrain.ckpt_lib.latest_checkpoint(tt.ckpt_dir, "t").endswith("t_ep0001.npz")
    psnr = tt.evaluate(_dataset(n=1, channels=3, seed=5))
    assert np.isfinite(psnr) and tt.stats["best_result"] == psnr
    tt.opt.scan_steps = 4
    tt.train(ds, max_epochs=1, steps_per_epoch=10)
    assert tt.global_step == 30 and len(tt.stats["loss"]) == 2
    frames = tt.test(_dataset(n=2, channels=3, seed=6), write_video=False)
    assert len(frames) == 2 and frames[0].shape == (HW, HW, 3)
    assert sorted(os.listdir(os.path.join(tt.workspace, "results"))) == [
        "t_0000.png", "t_0000_depth.png", "t_0001.png", "t_0001_depth.png"]
    _, _, field = extract_geometry(
        lambda x: tnet.density(tt.state.ema_params, x, tt.cfg)["sigma"], tt.cfg.bound,
        resolution=16, device="cpu")
    path = tt.save_mesh(resolution=16, threshold=float(np.median(field)))
    assert path == os.path.join(tt.workspace, "meshes", "t_2.ply")
    head = open(path).read().split("end_header")[0]
    assert "element vertex" in head and "element vertex 0\n" not in head
