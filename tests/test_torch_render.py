"""nerfnav_tpu_torch rays, compositing, rounds renderer and render_full vs
the JAX package's, on the CPU, on the same params and occupancy.

fp32 paths (mlp_backend "xla", float32 tables) must agree within 1e-5. The
fused-MLP path agrees within 2e-2: the JAX side runs the Pallas kernel in
interpret mode and the port its plain version, and the bf16 re-rounding of
hidden activations under a different f32 summation order can move an
activation by one bf16 step.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfnav_tpu.data import rays as jrays
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
from nerfnav_tpu_torch.training.checkpoint import occupancy_from_numpy, params_from_numpy
from nerfnav_tpu_torch.training.trainer import Trainer as TTrainer, TrainerOptions as TOpts
from test_torch_march import camera_rays, shell_occupancy

torch.set_num_threads(1)

POSE = np.eye(4, dtype=np.float32)
POSE[:3, 3] = [0.02, -0.01, -1.6]


def _net_cfg(**kw):
    base = dict(bound=1.0, grid_levels=2, grid_level_dim=8, grid_log2_hashmap_size=10,
                grid_max_resolution=32, grid_layout="cell", density_scale=40.0)
    base.update(kw)
    return base


def _params(cfg_kw, seed=0):
    pj = jnet.init_network(jax.random.PRNGKey(seed), jnet.NetworkConfig(**cfg_kw))
    pn = jax.tree_util.tree_map(np.asarray, pj)
    return pj, params_from_numpy(pn, device="cpu")


def test_tile_order_exact():
    for h, w in ((64, 64), (100, 70), (8, 130)):
        pj, ij = jrays.tile_order(h, w, 64)
        pt, it = trays.tile_order(h, w, 64)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(it, ij)


def test_rays_match():
    intr = np.asarray([30.0, 28.0, 15.5, 17.0], np.float32)
    rng = np.random.default_rng(0)
    pose = POSE.copy()
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    rj = jrays.get_all_rays(jnp.asarray(pose), jnp.asarray(intr), 24, 20)
    rt = trays.get_all_rays(torch.as_tensor(pose), torch.as_tensor(intr), 24, 20)
    i = rng.uniform(0, 20, 50).astype(np.float32)
    j = rng.uniform(0, 24, 50).astype(np.float32)
    off = np.asarray([0.25, -0.5], np.float32)
    pj = jrays.rays_from_pixels(jnp.asarray(pose), jnp.asarray(intr), jnp.asarray(i),
                                jnp.asarray(j), offset=jnp.asarray(off))
    pt = trays.rays_from_pixels(torch.as_tensor(pose), torch.as_tensor(intr),
                                torch.as_tensor(i), torch.as_tensor(j),
                                offset=torch.as_tensor(off))
    for a, b in ((rj, rt), (pj, pt)):
        for k in ("rays_o", "rays_d"):
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), rtol=0, atol=1e-5)


def test_near_far_and_composite():
    rng = np.random.default_rng(2)
    o, d = camera_rays(8, 1.0)
    aabb = np.asarray([-1, -1, -1, 1, 1, 1], np.float32)
    nj, fj = jrend.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb))
    nt, ft = trend.near_far_from_aabb(torch.as_tensor(o), torch.as_tensor(d),
                                      torch.as_tensor(aabb))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-5)
    sig = rng.uniform(0, 30, (16, 12)).astype(np.float32)
    rgb = rng.uniform(0, 1, (16, 12, 3)).astype(np.float32)
    dz = rng.uniform(0.001, 0.05, (16, 12)).astype(np.float32)
    z = np.cumsum(dz, axis=1)
    outj = jrend.composite(*map(jnp.asarray, (sig, rgb, dz, z)), 2.0)
    outt = trend.composite(*map(torch.as_tensor, (sig, rgb, dz, z)), 2.0)
    for a, b in zip(outj, outt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shade_order,round_compact", [("ray", 4), ("depth", 4),
                                                       ("ray", 0)])
def test_rounds_renderer_fp32(shade_order, round_compact, monkeypatch):
    """render_rays_grid_rounds, xla fp32 field: image/depth within 1e-5.

    The JAX renderer runs jitted, where XLA contracts multiply-adds into FMAs
    and can move a march sample across a cell boundary. Both renderers
    therefore shade the same march: the port's, which test_torch_march.py
    holds bit for bit against the JAX march run op by op."""
    kw = _net_cfg()
    pj, pt = _params(kw)
    occ, _ = shell_occupancy(32, 1)
    mkw = dict(bound=1.0, grid_size=32, max_steps=256, samples_per_ray=16,
               min_near=0.05, coarse_segments=12, coarse_anchors=2)
    o, d = camera_rays(16, 1.0, focal=20.0)
    args = dict(bg_color=1.0, round_samples=4, round_compact=round_compact,
                shade_order=shade_order)
    occ_j = {k: jnp.asarray(v) for k, v in occ.items()}
    occ_t = occupancy_from_numpy(occ, device="cpu")
    m_t = tm.march(torch.as_tensor(o), torch.as_tensor(d), occ_t, tm.MarchConfig(**mkw))
    m_j = {k: jnp.asarray(v.numpy()) for k, v in m_t.items()}
    monkeypatch.setattr(jm, "march", lambda *a, **k: m_j)
    field_j = jrend.make_field(pj, jnet.NetworkConfig(**kw))
    oj = jax.jit(lambda o_j, d_j: jrend.render_rays_grid_rounds(
        field_j, occ_j, jm.MarchConfig(**mkw), o_j, d_j, **args))(
        jnp.asarray(o), jnp.asarray(d))
    ot = trend.render_rays_grid_rounds(
        trend.make_field(pt, tnet.NetworkConfig(**kw)),
        occ_t, tm.MarchConfig(**mkw), torch.as_tensor(o), torch.as_tensor(d), **args)
    img = np.asarray(oj["image"])
    assert (img < 0.5).mean() > 0.05  # opaque geometry in view
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=0, atol=1e-5)


def _trainers(tmp_path, cfg_kw, bound, opt_kw, hw=16, grid=True, **mkw_extra):
    """A JAX Trainer and its port on the same params and shell occupancy
    (grid=False: the dense path, no occupancy grid)."""
    gs = 32
    cascades = 1 + int(np.ceil(np.log2(bound)))
    occ, _ = shell_occupancy(gs, cascades)
    mkw = dict(bound=bound, grid_size=gs, max_steps=256, samples_per_ray=8,
               min_near=0.05, **mkw_extra)
    rcfg_kw = dict(num_steps=16, upsample_steps=0, min_near=0.05, max_ray_batch=128)
    pj, pt = _params(cfg_kw)
    grid_kw_j = grid_kw_t = {}
    if grid:
        grid_kw_j = dict(occupancy_cfg=JOccCfg(bound=bound, grid_size=gs),
                         march_cfg=jm.MarchConfig(**mkw))
        grid_kw_t = dict(occupancy_cfg=TOccCfg(bound=bound, grid_size=gs),
                         march_cfg=tm.MarchConfig(**mkw),
                         occupancy=occupancy_from_numpy(occ, device="cpu"))
    tj = JTrainer(jnet.NetworkConfig(**cfg_kw), jrend.RenderConfig(**rcfg_kw),
                  JOpts(name="port", workspace=str(tmp_path / "j"),
                        use_checkpoint="scratch", **opt_kw), params=pj, **grid_kw_j)
    tj.state = tj._init_state(1)
    if grid:
        st = dict(tj.state.occupancy)
        st.update({k: jnp.asarray(v) for k, v in occ.items()})
        tj.state = tj.state._replace(occupancy=st)
        tj._occ_version += 1
    tt = TTrainer(tnet.NetworkConfig(**cfg_kw), trend.RenderConfig(**rcfg_kw),
                  TOpts(name="port", workspace=str(tmp_path / "t"), **opt_kw), params=pt,
                  device="cpu", **grid_kw_t)
    intr = np.asarray([hw * 1.4, hw * 1.4, hw / 2, hw / 2], np.float32)
    pose = POSE.copy()
    pose[2, 3] *= bound
    return tj, tt, pose, intr


def test_render_full_xla_fp32(tmp_path):
    """Trainer.render_full, xla fp32 field and tables, bound 1, beam off."""
    tj, tt, pose, intr = _trainers(
        tmp_path, _net_cfg(), 1.0, dict(eval_beam=1, eval_table_dtype="float32"))
    ij, dj = tj.render_full(tj.params, pose, intr, 16, 16)
    it, dt = tt.render_full(tt.params, pose, intr, 16, 16)
    assert tt._ladder_plan == tj._ladder_plan
    assert (np.asarray(ij) < 0.5).mean() > 0.05
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-5)


def test_render_full_fused_beam8(tmp_path):
    """Trainer.render_full on the -O --ff configuration: fused MLP, bf16
    tables, bound 2, eval_beam 8 (within 2e-2, see the module docstring)."""
    tj, tt, pose, intr = _trainers(
        tmp_path, _net_cfg(bound=2.0, mlp_backend="fused"), 2.0, dict(eval_beam=8))
    ij, dj = tj.render_full(tj.params, pose, intr, 16, 16)
    it, dt = tt.render_full(tt.params, pose, intr, 16, 16)
    assert tt._ladder_plan == tj._ladder_plan
    assert "blocks_coarse_dilated" in tt._beamed_occupancy(tt.occupancy)
    assert (np.asarray(ij) < 0.5).mean() > 0.05
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0, atol=2e-2)


def test_entry_points_need_cuda_or_cpu():
    """Without a CUDA device the default device raises; no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tnet.NetworkConfig(**_net_cfg())
    with pytest.raises(RuntimeError, match="cuda"):
        tnet.init_network(None, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        TTrainer(cfg, trend.RenderConfig(), TOpts())


def test_unported_options_raise(tmp_path):
    """The options this test once pinned as unported now run (the
    frame-level phase A, the phase-A0 prefilter, depth windows, the
    occupancy debounce; their parity: test_torch_march_options.py,
    test_torch_occupancy.py), and so do sample_groups > 1 and device meshes
    (their parity: test_torch_parallel.py): grouped packing at a budget, and
    a one-rank gloo mesh whose Trainer renders the meshless frame."""
    import torch.distributed as dist

    from nerfnav_tpu_torch.models.occupancy import init_occupancy_state
    from nerfnav_tpu_torch.parallel import make_mesh

    _, tt, pose, intr = _trainers(tmp_path, _net_cfg(), 1.0, {})
    tt.opt.eval_frame_phase_a = True
    img, _ = tt.render_full(tt.params, pose, intr, 8, 8)
    assert bool(torch.isfinite(img).all())
    tt.opt.eval_frame_phase_a = False
    tt.march_cfg = dataclasses.replace(tt.march_cfg, a0_segments=4)
    img, _ = tt.render_full(tt.params, pose, intr, 8, 8)
    assert bool(torch.isfinite(img).all())
    o, d = camera_rays(4, 1.0)
    m = tm.march(torch.as_tensor(o), torch.as_tensor(d), tt.occupancy,
                 tm.MarchConfig(bound=1.0, grid_size=32), z_window=(0.5, 1.5))
    assert m["z"][m["valid"]].max() <= 1.5
    st = init_occupancy_state(TOccCfg(bound=1.0, grid_size=32, occ_debounce=True),
                              device="cpu")
    assert not bool(st["pending"].any())
    field = trend.make_field(tt.params, tt.cfg)
    rays = (torch.as_tensor(o), torch.as_tensor(d))
    out = trend.render_rays_grid(field, tt.occupancy, tt.march_cfg, *rays, sample_groups=2,
                                 sample_budget=8)
    assert bool(torch.isfinite(out["image"]).all()) and int(out["n_samples"]) > 8
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        tm_ = TTrainer(tt.cfg, tt.rcfg, TOpts(workspace=str(tmp_path / "m")),
                       params=tt.params, occupancy_cfg=tt.occupancy_cfg,
                       march_cfg=tt.march_cfg, occupancy=tt.occupancy,
                       mesh=make_mesh(device_type="cpu"), device="cpu")
        img_m, _ = tm_.render_full(tm_.params, pose, intr, 8, 8)
    finally:
        dist.destroy_process_group()
    assert torch.equal(img_m, tt.render_full(tt.params, pose, intr, 8, 8)[0])


def test_beam_rules_match(tmp_path):
    """The AUTO beam width and its tile-row clamp agree with the reference."""
    tj, tt, _, _ = _trainers(tmp_path, _net_cfg(), 1.0, {})
    for w in (800, 820, 640, 840, 65, 16):
        for bm in (1, 2, 8, 16):
            assert tt._clamp_beam_to_rows(bm, w) == tj._clamp_beam_to_rows(bm, w)
    for mkw in (dict(bound=2.0, grid_size=128), dict(bound=1.0, grid_size=32)):
        tj.march_cfg = jm.MarchConfig(**mkw)
        tt.march_cfg = tm.MarchConfig(**mkw)
        for f in (20.0, 64.0, 800.0, 1000.0, 3000.0):
            intr = np.asarray([f, f * 1.1, 400, 400], np.float32)
            assert tt._auto_beam(intr) == tj._auto_beam(intr)


def _to_np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("error_map", [False, True])
def test_get_rays_match(error_map):
    """get_rays from the JAX key's draws: pixel indices exact, rays within
    1e-6."""
    H, W, n = 40, 56, 300
    intr = np.asarray([50.0, 48.0, 27.5, 20.0], np.float32)
    rng = np.random.default_rng(3)
    pose = POSE.copy()
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    key = jax.random.PRNGKey(11)
    emap = rng.uniform(0.01, 1.0, 128 * 128).astype(np.float32) if error_map else None
    rj = jrays.get_rays(jnp.asarray(pose), jnp.asarray(intr), H, W, n, key,
                        None if emap is None else jnp.asarray(emap))
    if emap is None:
        draws = trays.RayDraws(inds=torch.as_tensor(np.array(
            jax.random.randint(key, (n,), 0, H * W))).long())
    else:
        k1, k2 = jax.random.split(key)
        bins = jax.random.categorical(k1, jnp.log(jnp.asarray(emap) + 1e-8), shape=(n,))
        draws = trays.RayDraws(bins=torch.as_tensor(np.array(bins)).long(),
                               jitter=torch.as_tensor(np.array(
                                   jax.random.uniform(k2, (n, 2)))))
    rt = trays.get_rays(torch.as_tensor(pose), torch.as_tensor(intr), H, W, draws,
                        None if emap is None else torch.as_tensor(emap))
    np.testing.assert_array_equal(rt["inds"].numpy(), np.asarray(rj["inds"]))
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), rtol=0, atol=1e-6)
    # the run-time draws: a seeded generator, in range, error-weighted
    gen = torch.Generator().manual_seed(0)
    d = trays.draw_rays(gen, 4096, H, W, None if emap is None else torch.as_tensor(emap))
    inds = trays.get_rays(torch.as_tensor(pose), torch.as_tensor(intr), H, W, d,
                          None if emap is None else torch.as_tensor(emap))["inds"]
    assert 0 <= int(inds.min()) and int(inds.max()) < H * W


def test_pack_indices_exact():
    """Packed slot -> (ray, position) against the JAX scatter-max form, with
    empty rays and a budget below and above the valid count."""
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 9, 64)
    counts[[0, 5, 6, 63]] = 0
    valid = np.arange(8)[None, :] < counts[:, None]
    pack_j = jax.jit(jrend._pack_indices, static_argnums=1)
    for budget in (50, int(counts.sum()), 600):
        for a, b in zip(trend._pack_indices(torch.as_tensor(valid), budget),
                        pack_j(jnp.asarray(valid), budget)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("budget", [None, 1024, 2048])
def test_render_rays_grid_with_grads(budget, monkeypatch):
    """The training render, xla fp32 field, dense and packed at budgets below
    and above the valid count: image, depth and the gradients of both w.r.t.
    every param within 1e-5 (of each tensor's largest entry). Both shade the
    port's keyed march, which test_torch_march.py holds against the JAX one."""
    kw = _net_cfg(bound=2.0, density_scale=8.0)
    pj, pt = _params(kw)
    occ, _ = shell_occupancy(32, 2)
    mkw = dict(bound=2.0, grid_size=32, max_steps=256, samples_per_ray=16,
               min_near=0.05, coarse_normalized=False)
    o, d = camera_rays(16, 2.0, focal=14.0)
    n = o.shape[0]
    rng = np.random.default_rng(7)
    mkey = tm.MarchKey(u=torch.as_tensor(rng.random(n, dtype=np.float32)),
                       phase=torch.as_tensor(rng.integers(0, 2**30, (n, 1))))
    occ_t = occupancy_from_numpy(occ, device="cpu")
    m_t = tm.march(torch.as_tensor(o), torch.as_tensor(d), occ_t, tm.MarchConfig(**mkw),
                   key=mkey)
    n_valid = int(m_t["valid"].sum())
    assert 1024 < n_valid < 2048 < n * 16
    monkeypatch.setattr(jm, "march", lambda *a, **k: {
        key: jnp.asarray(v.numpy()) for key, v in m_t.items()})
    bg = rng.random((n, 3), dtype=np.float32)
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wd = rng.normal(size=(n,)).astype(np.float32)

    def loss_j(p):
        out = jrend.render_rays_grid(jrend.make_field(p, jnet.NetworkConfig(**kw)), None,
                                     jm.MarchConfig(**mkw), jnp.asarray(o), jnp.asarray(d),
                                     bg_color=jnp.asarray(bg), sample_budget=budget)
        return jnp.sum(out["image"] * wi) + jnp.sum(out["depth"] * wd), out

    # jitted: the march is the port's either way, and one compile beats
    # hundreds of op-by-op ones
    (_, oj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(pj)
    leaves = [t.requires_grad_() for k in sorted(pt) for t in pt[k]]
    ot = trend.render_rays_grid(trend.make_field(pt, tnet.NetworkConfig(**kw)), occ_t,
                                tm.MarchConfig(**mkw), torch.as_tensor(o),
                                torch.as_tensor(d), key=mkey, bg_color=torch.as_tensor(bg),
                                sample_budget=budget)
    ((ot["image"] * torch.as_tensor(wi)).sum() + (ot["depth"] * torch.as_tensor(wd)).sum()
     ).backward()
    assert int(ot["n_samples"]) == int(oj["n_samples"]) == n_valid
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(ot[k].detach().numpy(), np.asarray(oj[k]), rtol=0, atol=1e-5)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(gj)):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


def _march_by_port(monkeypatch, occ_t):
    """Let the jitted JAX renderers shade the port's march of their rays (a
    host callback): under jit XLA contracts the JAX march's multiply-adds
    into FMAs and moves samples across cell boundaries, and the port
    matches the march run op by op (test_torch_march.py)."""
    def march_j(rays_o, rays_d, occupancy, cfg, key=None, crop_aabb=None, **kw):
        cfg_t = tm.MarchConfig(**dataclasses.asdict(cfg))
        n, k = rays_o.shape[0], cfg.samples_per_ray
        f32 = jnp.float32
        shapes = {"z": jax.ShapeDtypeStruct((n, k), f32),
                  "dt": jax.ShapeDtypeStruct((n, k), f32),
                  "valid": jax.ShapeDtypeStruct((n, k), jnp.bool_),
                  "near": jax.ShapeDtypeStruct((n,), f32),
                  "far": jax.ShapeDtypeStruct((n,), f32)}

        def run(o, d, *crop):
            m = tm.march(torch.as_tensor(np.asarray(o)), torch.as_tensor(np.asarray(d)),
                         occ_t, cfg_t,
                         crop_aabb=torch.as_tensor(np.asarray(crop[0])) if crop else None)
            return {name: v.numpy() for name, v in m.items()}

        extra = () if crop_aabb is None else (crop_aabb,)
        return jax.pure_callback(run, shapes, rays_o, rays_d, *extra)

    monkeypatch.setattr(jm, "march", march_j)


@pytest.mark.parametrize("mode", ["gamma", "one_shot", "dense"])
def test_render_full_reference_branches(tmp_path, mode, monkeypatch):
    """render_full on the branches of the reference-exact configuration, xla
    fp32 field and tables, image and depth within 1e-5: the rounds path on
    the static gamma ladder (dt_gamma 1/128, its planned span equal), the
    one-shot grid render (eval_rounds=False, row-major chunks) and the dense
    render_rays without an occupancy grid; each also inside a crop AABB. The
    grid paths shade the port's march (see _march_by_port)."""
    opt = dict(eval_beam=1, eval_table_dtype="float32")
    mkw = {}
    if mode == "gamma":
        mkw = dict(dt_gamma=1 / 128)
    elif mode == "one_shot":
        opt["eval_rounds"] = False
    tj, tt, pose, intr = _trainers(tmp_path, _net_cfg(), 1.0, opt, grid=mode != "dense",
                                   **mkw)
    if mode != "dense":
        _march_by_port(monkeypatch, tt.occupancy)
    crop = np.asarray([-0.6, -0.5, -0.7, 0.4, 0.6, 0.3], np.float32)
    for c in (None, crop):
        ij, dj = tj.render_full(tj.params, pose, intr, 16, 16,
                                crop_aabb=None if c is None else jnp.asarray(c))
        it, dt = tt.render_full(tt.params, pose, intr, 16, 16, crop_aabb=c)
        assert (np.asarray(ij) < 0.5).mean() > 0.05
        np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0, atol=1e-5)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-5)
    assert tt._ladder_plan == tj._ladder_plan
    if mode == "gamma":  # a span (the speckled shell fills the cube: no shrink)
        assert isinstance(tt._ladder_plan[1], float)
    assert not np.allclose(it.numpy(), tt.render_full(tt.params, pose, intr, 16, 16)[0])


def test_render_rays_crop_matches():
    """The dense render_rays inside a crop AABB, analytic-free: the port's
    network field against the JAX one, within 1e-5."""
    kw = _net_cfg()
    pj, pt = _params(kw)
    o, d = camera_rays(8, 1.0, focal=10.0)
    crop = np.asarray([-0.5, -0.4, -0.6, 0.5, 0.3, 0.2], np.float32)
    rcfg = dict(num_steps=24, upsample_steps=0, min_near=0.05)
    oj = jrend.render_rays(jrend.make_field(pj, jnet.NetworkConfig(**kw)),
                           jrend.RenderConfig(**rcfg), jnp.asarray(o), jnp.asarray(d),
                           crop_aabb=jnp.asarray(crop))
    ot = trend.render_rays(trend.make_field(pt, tnet.NetworkConfig(**kw)),
                           trend.RenderConfig(**rcfg), torch.as_tensor(o),
                           torch.as_tensor(d), crop_aabb=torch.as_tensor(crop))
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=0, atol=1e-5)


class _Views:
    """What evaluate and test read: poses, intrinsics, H, W, as_arrays()."""

    def __init__(self, poses, images, intrinsics):
        self.poses, self.images, self.intrinsics = poses, images, intrinsics
        self.H, self.W = images.shape[1:3]

    def __len__(self):
        return len(self.poses)

    def as_arrays(self):
        return {"poses": self.poses, "images": self.images, "intrinsics": self.intrinsics}


def test_evaluate_and_test_write_images(tmp_path, monkeypatch):
    """evaluate on the gamma grid path: the PSNR within 1e-4 of the JAX
    Trainer's and the validation PNGs within one 8-bit code value; test:
    the uint8 frames within one code value, the frame and depth PNGs under
    results/ and the mp4 (or the log line that says why not)."""
    import cv2

    tj, tt, pose, intr = _trainers(tmp_path, _net_cfg(), 1.0,
                                   dict(eval_beam=1, eval_table_dtype="float32"),
                                   dt_gamma=1 / 128)
    _march_by_port(monkeypatch, tt.occupancy)
    rng = np.random.default_rng(4)
    poses = np.stack([pose, pose])
    poses[1, 0, 3] += 0.1
    views = _Views(poses, rng.random((2, 16, 16, 4)).astype(np.float32), intr)
    pj, pt = tj.evaluate(views), tt.evaluate(views)
    assert pt == pytest.approx(pj, abs=1e-4)
    names = sorted(os.listdir(tmp_path / "t" / "validation"))
    assert names == sorted(os.listdir(tmp_path / "j" / "validation")) and len(names) == 2
    for n in names:
        a = cv2.imread(str(tmp_path / "t" / "validation" / n)).astype(int)
        b = cv2.imread(str(tmp_path / "j" / "validation" / n)).astype(int)
        assert np.abs(a - b).max() <= 1
    fj, ft = tj.test(views), tt.test(views)
    for a, b in zip(ft, fj):
        assert a.dtype == np.uint8 and np.abs(a.astype(int) - np.asarray(b, int)).max() <= 1
    out = set(os.listdir(tmp_path / "t" / "results"))
    assert {"port_0000.png", "port_0001.png", "port_0000_depth.png"} <= out
    with open(tmp_path / "t" / "log_port.txt") as f:
        assert "port.mp4" in out or "no mp4 writer opened" in f.read()
