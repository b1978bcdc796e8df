"""nerfnav_tpu_torch's grouped packing and data parallel over a device mesh vs
the JAX package's, on the CPU.

Grouped packing (`sample_groups`, `_shade_packed(groups=)`): packed indices
exact, images and gradients within 1e-5 (xla fp32 field), against the JAX
functions on the port's march.

The mesh: one torch.multiprocessing spawn of two gloo ranks (a file:// store
under tmp_path, so no port is opened) runs two mesh train steps of a tiny grid
trainer at a point budget (each rank packs its block into budget / 2 slots),
one sharded occupancy sweep and one 8x8 render_full. Its params, occupancy and
image must equal the port's single process with sample_groups = 2 (1e-6) and
JAX's Trainer(mesh=make_mesh(2)) on the conftest's CPU devices (1e-5), all from
the same draws (split from the JAX keys as the JAX step splits them). With
Adam's eps = 1e-15 a first step is lr sign(g), so params are held only where
each step's gradient is 0 or above 1e-6 of its largest entry (as in
test_torch_train.py); the gradients themselves are held within 1e-6 of each
tensor's largest entry. The JAX side marches with the port's march through a
host callback (the JAX march run under jit contracts FMAs; see
test_torch_render.py).

The spawned ranks import this module: JAX is imported only inside the tests,
so a rank imports torch and the port alone.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nerfnav_tpu_torch.models import network as tnet
from nerfnav_tpu_torch.models import renderer as trend
from nerfnav_tpu_torch.models.occupancy import OccupancyConfig as TOccCfg, update_extra_state
from nerfnav_tpu_torch.ops import marching as tm
from nerfnav_tpu_torch.parallel import make_mesh
from nerfnav_tpu_torch.training import trainer as ttrain
from nerfnav_tpu_torch.training.checkpoint import occupancy_from_numpy, params_from_numpy

torch.set_num_threads(1)

HW, N_RAYS, WORLD, FRAME = 24, 256, 2, 8
NET = dict(bound=2.0, grid_levels=2, grid_level_dim=8, grid_log2_hashmap_size=10,
           grid_max_resolution=32, grid_layout="cell", density_scale=10.0)
MARCH = dict(bound=2.0, grid_size=32, max_steps=256, samples_per_ray=16, min_near=0.05)
OCC = dict(bound=2.0, grid_size=32, update_chunk=8192, density_thresh=10.0, min_near=0.05)
BUDGET = 1024   # of 256 x 16 slots: below the valid count, so packing drops tails
MESH_BUDGET = 256
OPTS = dict(num_rays=N_RAYS, iters=200, use_checkpoint="scratch", error_map=True,
            eval_table_dtype="float32",
            point_budget_fracs=(MESH_BUDGET / (N_RAYS * MARCH["samples_per_ray"]), 0.25))


# ------------------------------------------------------------ grouped packing
def _march_case():
    """Params of a small fp32 field and the port's keyed march of a 16x16
    frame through a shell occupancy: ((pj, pt), cfg kw, rays, march)."""
    import jax

    from nerfnav_tpu.models import network as jnet
    from test_torch_march import camera_rays, shell_occupancy

    kw = dict(NET, density_scale=8.0)
    pj = jnet.init_network(jax.random.PRNGKey(0), jnet.NetworkConfig(**kw))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    occ_t = occupancy_from_numpy(shell_occupancy(32, 2)[0], device="cpu")
    mkw = dict(MARCH, coarse_normalized=False)
    o, d = camera_rays(16, 2.0, focal=14.0)
    rng = np.random.default_rng(7)
    n = o.shape[0]
    key = tm.MarchKey(u=torch.as_tensor(rng.random(n, dtype=np.float32)),
                      phase=torch.as_tensor(rng.integers(0, 2**30, (n, 1))))
    m = tm.march(torch.as_tensor(o), torch.as_tensor(d), occ_t, tm.MarchConfig(**mkw), key=key)
    assert BUDGET < int(m["valid"].sum()) < 2 * BUDGET
    return (pj, pt), kw, mkw, (o, d), key, occ_t, m


def _assert_grads(leaves_t, grads_j, rel=1e-5):
    import jax

    for a, b in zip(leaves_t, jax.tree_util.tree_leaves(grads_j)):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=0, atol=rel * np.abs(b).max())


@pytest.mark.parametrize("groups", [2, 4, 8])
def test_shade_packed_groups_match(groups):
    """_shade_packed(groups=) at 2, 4 and 8 blocks: the packed indices of each
    block exactly, sigma and colour and their gradients w.r.t. every param
    within 1e-5; the blocks drop other samples than one global packing."""
    import jax
    import jax.numpy as jnp

    from nerfnav_tpu.models import network as jnet
    from nerfnav_tpu.models import renderer as jrend

    (pj, pt), kw, _, (o, d), _, _, m = _march_case()
    z, dt, valid = (m[k] for k in ("z", "dt", "valid"))
    n, k = z.shape
    vg = valid.reshape(groups, n // groups, k)
    pack_j = jax.jit(jax.vmap(lambda v: jrend._pack_indices(v, BUDGET // groups)))
    for a, b in zip(trend._pack_indices(vg, BUDGET // groups), pack_j(jnp.asarray(vg.numpy()))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a block overflows its share while the frame fits more: other samples
    counts = vg.sum(dim=(1, 2))
    assert int(counts.max()) > BUDGET // groups

    rng = np.random.default_rng(groups)
    ws = rng.normal(size=(n, k)).astype(np.float32)
    wc = rng.normal(size=(n, k, 3)).astype(np.float32)
    cfg_j = jnet.NetworkConfig(**kw)
    zj, dtj, vj = (jnp.asarray(t.numpy()) for t in (z, dt, valid))

    def loss_j(p):
        s, c = jrend._shade_packed(jrend.make_field(p, cfg_j), jnp.asarray(o), jnp.asarray(d),
                                   zj, dtj, vj, BUDGET, 2.0, groups=groups)
        return jnp.sum(s * ws) + jnp.sum(c * wc), (s, c)

    (_, (sj, cj)), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(pj)
    leaves = [t.requires_grad_() for key in sorted(pt) for t in pt[key]]
    st, ct = trend._shade_packed(trend.make_field(pt, tnet.NetworkConfig(**kw)),
                                 torch.as_tensor(o), torch.as_tensor(d), z, valid, BUDGET, 2.0,
                                 groups=groups)
    ((st * torch.as_tensor(ws)).sum() + (ct * torch.as_tensor(wc)).sum()).backward()
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ct.detach().numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    assert int((st != 0).sum()) <= BUDGET
    _assert_grads(leaves, gj)


def test_render_rays_grid_sample_groups_match(monkeypatch):
    """render_rays_grid(sample_groups=4) at a budget below the valid count:
    image, depth and the gradients w.r.t. every param within 1e-5."""
    import jax
    import jax.numpy as jnp

    from nerfnav_tpu.models import network as jnet
    from nerfnav_tpu.models import renderer as jrend
    from nerfnav_tpu.ops import marching as jm

    (pj, pt), kw, mkw, (o, d), key, occ_t, m = _march_case()
    monkeypatch.setattr(jm, "march", lambda *a, **k: {
        name: jnp.asarray(v.numpy()) for name, v in m.items()})
    n = o.shape[0]
    rng = np.random.default_rng(3)
    bg = rng.random((n, 3), dtype=np.float32)
    wi = rng.normal(size=(n, 3)).astype(np.float32)

    def loss_j(p):
        out = jrend.render_rays_grid(jrend.make_field(p, jnet.NetworkConfig(**kw)), None,
                                     jm.MarchConfig(**mkw), jnp.asarray(o), jnp.asarray(d),
                                     bg_color=jnp.asarray(bg), sample_budget=BUDGET,
                                     sample_groups=4)
        return jnp.sum(out["image"] * wi), out

    (_, oj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(pj)
    leaves = [t.requires_grad_() for k in sorted(pt) for t in pt[k]]
    ot = trend.render_rays_grid(trend.make_field(pt, tnet.NetworkConfig(**kw)), occ_t,
                                tm.MarchConfig(**mkw), torch.as_tensor(o), torch.as_tensor(d),
                                key=key, bg_color=torch.as_tensor(bg), sample_budget=BUDGET,
                                sample_groups=4)
    (ot["image"] * torch.as_tensor(wi)).sum().backward()
    assert int(ot["n_samples"]) == int(oj["n_samples"])
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(ot[k].detach().numpy(), np.asarray(oj[k]), rtol=0, atol=1e-5)
    _assert_grads(leaves, gj)
    with pytest.raises(AssertionError):
        trend.render_rays_grid(trend.make_field(pt, tnet.NetworkConfig(**kw)), occ_t,
                               tm.MarchConfig(**mkw), torch.as_tensor(o), torch.as_tensor(d),
                               key=key, sample_budget=BUDGET + 2, sample_groups=4)


# ------------------------------------------------------------------- the mesh
def _port_trainer(inp, mesh, **kw):
    """The port Trainer of the mesh case, on the CPU."""
    tr = ttrain.Trainer(
        tnet.NetworkConfig(**NET), trend.RenderConfig(),
        ttrain.TrainerOptions(name="t", workspace=inp["workspace"], **OPTS),
        params=params_from_numpy(inp["params"], device="cpu"),
        occupancy_cfg=TOccCfg(**OCC), march_cfg=tm.MarchConfig(**MARCH),
        occupancy=occupancy_from_numpy(inp["occupancy"], device="cpu"), mesh=mesh,
        device="cpu", **kw)
    tr.state.error_maps = torch.full((2, 128 * 128), 0.1)
    tr._mean_count_host = inp["mean_count_host"]
    return tr


def _run_case(tr, inp):
    """Two train steps, one sweep and one FRAME x FRAME render_full from the
    case's draws; returns what the test compares (numpy)."""
    arrays = {k: torch.as_tensor(v) for k, v in inp["arrays"].items()}
    out = {"loss": [], "grads": [], "n_samples": [], "budget": tr._current_budget()}
    for draws in inp["draws"]:
        so = tr.loss_and_grads(tr.state, arrays, draws)
        tr.apply(tr.state, so, draws.idx, HW, HW)
        out["loss"].append(float(so.loss))
        out["n_samples"].append(int(so.n_samples))
        out["grads"].append([g.numpy().copy() for g in so.grads])
    tr.set_occupancy(update_extra_state(tr.occupancy, tr.occupancy_cfg, tr.params, tr.cfg,
                                        inp["sweep_draws"], mesh=tr.mesh))
    img, depth = tr.render_full(tr.params, inp["pose"], inp["intr"], FRAME, FRAME)
    out.update(
        params=[p.detach().numpy().copy() for p in ttrain._leaves(tr.params)],
        ema=[p.numpy().copy() for p in ttrain._leaves(tr.state.ema_params)],
        error_maps=tr.state.error_maps.numpy().copy(),
        mean_count=float(tr.state.mean_count), image=img.numpy(), depth=depth.numpy(),
        occupancy={k: v.numpy().copy() for k, v in tr.occupancy.items()})
    return out


def _mesh_worker(rank, store, io_dir):
    """One rank of the mesh case (imports torch and the port only)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    try:
        inp = torch.load(os.path.join(io_dir, "inputs.pt"), weights_only=False)
        mesh = make_mesh(device_type="cpu")
        refused = {}
        try:
            make_mesh(WORLD + 1, device_type="cpu")
        except ValueError as e:
            refused["make_mesh"] = str(e)
        try:
            ttrain.Trainer(tnet.NetworkConfig(**NET), trend.RenderConfig(),
                           ttrain.TrainerOptions(**dict(OPTS, num_rays=N_RAYS + 1)),
                           mesh=mesh, device="cpu")
        except ValueError as e:
            refused["num_rays"] = str(e)
        try:
            _port_trainer(inp, mesh, sample_groups=WORLD)
        except ValueError as e:
            refused["sample_groups"] = str(e)
        tr = _port_trainer(inp, mesh)
        out = _run_case(tr, inp)
        out.update(refused=refused, rank=tr._rank, groups=tr._groups)
        torch.save(out, os.path.join(io_dir, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _draws_from_key(key, emap, idx):
    """The port's StepDraws from a JAX step key, split as the JAX step and
    march split it (error-map ray draws)."""
    import jax
    import jax.numpy as jnp

    k_ray, k_perturb, k_bg = jax.random.split(key, 3)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    k1, k2 = jax.random.split(k_ray)
    k_start, k_phase = jax.random.split(k_perturb)
    return ttrain.StepDraws(
        idx=idx, rays=ttrain.RayDraws(
            bins=t(jax.random.categorical(k1, jnp.log(jnp.asarray(emap) + 1e-8),
                                          shape=(N_RAYS,))).long(),
            jitter=t(jax.random.uniform(k2, (N_RAYS, 2)))),
        bg=t(jax.random.uniform(k_bg, (N_RAYS, 3))),
        march=tm.MarchKey(u=t(jax.random.uniform(k_start, (N_RAYS,))),
                          phase=t(jax.random.randint(k_phase, (N_RAYS, 1), 0, 2**30)).long()))


def _march_through_port(monkeypatch):
    """Let the jitted JAX programs march with the port's march of their
    rays, occupancy and key, through a host callback."""
    import jax
    import jax.numpy as jnp

    from nerfnav_tpu.ops import marching as jm

    def march_j(rays_o, rays_d, occupancy, cfg, key=None, crop_aabb=None, **kw):
        assert crop_aabb is None and all(v is None or v == "" for v in kw.values())
        cfg_t = tm.MarchConfig(**dataclasses.asdict(cfg))
        n, k = rays_o.shape[0], cfg.samples_per_ray
        names = sorted(occupancy)
        draws = ()
        if key is not None:
            k_start, k_phase = jax.random.split(key)
            draws = (jax.random.uniform(k_start, (n,)),
                     jax.random.randint(k_phase, (n, 1), 0, 2**30))
        f32 = jnp.float32
        shapes = {"z": jax.ShapeDtypeStruct((n, k), f32),
                  "dt": jax.ShapeDtypeStruct((n, k), f32),
                  "valid": jax.ShapeDtypeStruct((n, k), jnp.bool_),
                  "near": jax.ShapeDtypeStruct((n,), f32),
                  "far": jax.ShapeDtypeStruct((n,), f32)}

        def run(o, d, occ, *dr):
            occ_t = occupancy_from_numpy(
                {name: np.asarray(v) for name, v in zip(names, occ)}, device="cpu")
            mk = None if not dr else tm.MarchKey(
                u=torch.as_tensor(np.asarray(dr[0])),
                phase=torch.as_tensor(np.asarray(dr[1])).long())
            m = tm.march(torch.as_tensor(np.asarray(o)), torch.as_tensor(np.asarray(d)),
                         occ_t, cfg_t, key=mk)
            return {name: v.numpy() for name, v in m.items()}

        return jax.pure_callback(run, shapes, rays_o, rays_d,
                                 [occupancy[name] for name in names], *draws)

    monkeypatch.setattr(jm, "march", march_j)


def _held(a, b, grads, what, atol):
    """a vs b within atol where every step's gradient is 0 or above 1e-6 of
    its largest entry; returns the entries held."""
    keep = np.ones(a.shape, bool)
    for g in grads:
        keep &= (np.abs(g) > 1e-6 * np.abs(g).max()) | (g == 0)
    np.testing.assert_allclose(a[keep], b[keep], rtol=0, atol=atol, err_msg=what)
    return int(keep.sum()), int((~keep).sum())


def test_mesh_matches_single_process_and_jax(tmp_path, monkeypatch):
    """Two gloo ranks: two mesh train steps at budget 256 (128 slots a
    rank), one sharded full sweep and an 8x8 render_full, against the port's
    single process with sample_groups = 2 (1e-6) and JAX's 2-device mesh
    Trainer (1e-5); make_mesh of another size, num_rays not dividing by
    the mesh and sample_groups beside a mesh refuse."""
    import jax
    import jax.numpy as jnp

    from nerfnav_tpu.models import network as jnet
    from nerfnav_tpu.models import occupancy as jocc
    from nerfnav_tpu.models import renderer as jrend
    from nerfnav_tpu.ops import marching as jm
    from nerfnav_tpu.parallel import make_mesh as jmake_mesh
    from nerfnav_tpu.training import Trainer as JTrainer, TrainerOptions as JOpts
    from test_torch_march import shell_occupancy
    from test_torch_occupancy import _draws as sweep_draws
    from test_torch_train import _dataset

    pj = jnet.init_network(jax.random.PRNGKey(0), jnet.NetworkConfig(**NET))
    occ, _ = shell_occupancy(32, 2)
    ds = _dataset()
    intr = np.asarray([FRAME * 1.2, FRAME * 1.2, FRAME / 2, FRAME / 2], np.float32)
    # the JAX Trainer on a 2-device mesh
    tj = JTrainer(jnet.NetworkConfig(**NET), jrend.RenderConfig(),
                  JOpts(name="j", workspace=str(tmp_path / "j"), **OPTS), params=pj,
                  occupancy_cfg=jocc.OccupancyConfig(**OCC),
                  march_cfg=jm.MarchConfig(**MARCH), mesh=jmake_mesh(WORLD))
    tj.state = tj._init_state(2)
    tj.state = tj.state._replace(occupancy={**tj.state.occupancy,
                                            **{k: jnp.asarray(v) for k, v in occ.items()}})
    tj._mean_count_host = MESH_BUDGET / 1.15 - 1.0
    assert tj._current_budget() == MESH_BUDGET

    keys = [jax.random.PRNGKey(5), jax.random.PRNGKey(6)]
    idxs = [1, 0]
    sweep_key = jax.random.PRNGKey(9)
    inp = {"workspace": str(tmp_path / "t"), "mean_count_host": tj._mean_count_host,
           "params": jax.tree_util.tree_map(np.asarray, pj),
           "occupancy": jax.tree_util.tree_map(np.asarray, tj.state.occupancy),
           "arrays": {k: np.asarray(v) for k, v in ds.as_arrays().items()},
           "pose": ds.poses[0], "intr": intr,
           "sweep_draws": sweep_draws(jocc.OccupancyConfig(**OCC), sweep_key, False)}

    _march_through_port(monkeypatch)
    arrays_j = {k: jnp.asarray(v) for k, v in ds.as_arrays().items()}
    draws, losses_j = [], []
    for key, idx in zip(keys, idxs):
        draws.append(_draws_from_key(key, np.asarray(tj.state.error_maps[idx]), idx))
        tj.state, loss = tj._step_fn(HW, HW, 4)(tj.state, arrays_j, jnp.asarray(idx), key)
        tj.global_step += 1
        losses_j.append(float(loss))
    inp["draws"] = draws
    tj.state = tj.state._replace(occupancy=jocc.update_extra_state(
        tj.state.occupancy, tj.occupancy_cfg, tj.state.params, tj.cfg, sweep_key, mesh=tj.mesh))
    tj._occ_version += 1
    img_j, depth_j = tj.render_full(tj.state.params, inp["pose"], intr, FRAME, FRAME)

    torch.save(inp, tmp_path / "inputs.pt")
    mp.spawn(_mesh_worker, args=(str(tmp_path / "store"), str(tmp_path)), nprocs=WORLD)
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(WORLD)]

    single = _port_trainer(inp, None, sample_groups=WORLD)
    ref = _run_case(single, inp)

    for r, out in enumerate(outs):
        assert out["rank"] == r and out["groups"] == WORLD
        assert set(out["refused"]) == {"make_mesh", "num_rays", "sample_groups"}
        assert "must divide evenly across 2 devices" in out["refused"]["num_rays"]
    mesh, other = outs
    # every rank holds the same state and frame
    for a, b in zip(mesh["params"] + [mesh["image"]], other["params"] + [other["image"]]):
        np.testing.assert_array_equal(a, b)
    assert mesh["budget"] == ref["budget"] == MESH_BUDGET
    assert mesh["n_samples"] == ref["n_samples"] and min(ref["n_samples"]) > MESH_BUDGET
    np.testing.assert_allclose(mesh["loss"], ref["loss"], rtol=1e-6)
    np.testing.assert_allclose(mesh["loss"], losses_j, rtol=1e-5)
    for ga, gb in zip(mesh["grads"], ref["grads"]):
        for a, b in zip(ga, gb):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(mesh["mean_count"], float(tj.state.mean_count), rtol=1e-6)
    np.testing.assert_allclose(mesh["error_maps"], np.asarray(tj.state.error_maps),
                               rtol=0, atol=1e-6)
    held = left = 0
    leaves_j = jax.tree_util.tree_leaves(tj.state.params)
    ema_j = jax.tree_util.tree_leaves(tj.state.ema_params)
    for i, (a, b, e, eb) in enumerate(zip(mesh["params"], ref["params"], mesh["ema"], ref["ema"])):
        grads = [g[i] for g in ref["grads"]]
        h, lo = _held(a, b, grads, f"param {i} vs single", 1e-6)
        _held(e, eb, grads, f"ema {i} vs single", 1e-6)
        _held(a, np.asarray(leaves_j[i]), grads, f"param {i} vs JAX", 1e-5)
        _held(e, np.asarray(ema_j[i]), grads, f"ema {i} vs JAX", 1e-5)
        held, left = held + h, left + lo
    assert held > 10 * left, (held, left)
    occ_j = jax.tree_util.tree_map(np.asarray, tj.state.occupancy)
    for k in ("density_grid", "density_coarse_min"):
        np.testing.assert_allclose(mesh["occupancy"][k], ref["occupancy"][k], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(mesh["occupancy"][k], occ_j[k], rtol=1e-5, atol=1e-5)
    for k in ("bitfield", "bitfield_coarse", "blocks", "blocks_coarse"):
        np.testing.assert_array_equal(mesh["occupancy"][k], ref["occupancy"][k])
        np.testing.assert_array_equal(mesh["occupancy"][k],
                                      occ_j[k].astype(mesh["occupancy"][k].dtype))
    assert 0 < np.unpackbits(mesh["occupancy"]["bitfield"]).mean() < 1
    np.testing.assert_allclose(mesh["image"], ref["image"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(mesh["depth"], ref["depth"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(mesh["image"], np.asarray(img_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mesh["depth"], np.asarray(depth_j), rtol=0, atol=1e-5)
    assert (mesh["image"] < 0.999).mean() > 0.2


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device_type="cpu")
