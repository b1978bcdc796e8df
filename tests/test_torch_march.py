"""nerfnav_tpu_torch march vs the JAX package's, on the CPU.

The same rays and occupancy (made with numpy from a seed) go through
nerfnav_tpu.ops.marching and its port. Integer outputs (valid masks, plans,
packed rows) must match exactly, z/dt to rtol 1e-6 and near/far to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfnav_tpu.ops import marching as jm
from nerfnav_tpu_torch.ops import marching as tm
from nerfnav_tpu_torch.training.checkpoint import occupancy_from_numpy

torch.set_num_threads(1)


def _pack_blocks_np(occ, h, b):
    """numpy form of ops/morton.pack_blocks (held against both packers in
    test_torch_ops.py::test_morton_packing_exact)."""
    nb = h // b
    o = occ.reshape(-1, nb, b, nb, b, nb, b).transpose(0, 1, 3, 5, 2, 4, 6)
    o = o.reshape(occ.shape[0], nb**3, b**3 // 32, 32).astype(np.uint64)
    return (o << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def shell_occupancy(grid_size, cascades, coarse_factor=4, seed=0):
    """Numpy occupancy of a shell + floor (cascade 0) and a ball (outer
    cascades) with random speckle, in the JAX package's packed layouts:
    {"bitfield", "bitfield_coarse", "blocks", "blocks_coarse"} (uint8 /
    uint32 numpy) and the unpacked (cascades, H^3) bool grid."""
    rng = np.random.default_rng(seed)
    h = grid_size
    idx = np.arange(h**3)
    c = (np.stack([idx // (h * h), (idx // h) % h, idx % h], -1) + 0.5) / h * 2 - 1
    r = np.linalg.norm(c, axis=-1)
    occ0 = ((r > 0.35) & (r < 0.55)) | (np.abs(c[:, 2] + 0.8) < 0.07)
    occ0 |= rng.random(h**3) < 0.01
    occs = np.stack([occ0] + [r < 0.3] * (cascades - 1))
    hc = h // coarse_factor
    f = coarse_factor
    occ_c = occs.reshape(-1, hc, f, hc, f, hc, f).max(axis=(2, 4, 6)).reshape(
        cascades, -1)
    return {
        "bitfield": np.packbits(occs, axis=-1, bitorder="little"),
        "bitfield_coarse": np.packbits(occ_c, axis=-1, bitorder="little"),
        "blocks": _pack_blocks_np(occs, h, 4),
        "blocks_coarse": _pack_blocks_np(occ_c, hc, 8 if hc % 8 == 0 else 4),
    }, occs


def camera_rays(n_side, bound, focal=24.0, seed=0, tile_major=True):
    """Rays of an n_side^2 pinhole frame looking at the origin from -z, in
    64-px tile order, with a small random pose jitter."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(n_side, dtype=np.float32),
                         np.arange(n_side, dtype=np.float32), indexing="ij")
    d = np.stack([(ii + 0.5 - n_side / 2) / focal, (jj + 0.5 - n_side / 2) / focal,
                  np.ones_like(ii)], -1).reshape(-1, 3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ang = rng.normal(scale=0.05, size=3)
    cx, cy = np.cos(ang), np.sin(ang)
    rot = (np.array([[1, 0, 0], [0, cx[0], -cy[0]], [0, cy[0], cx[0]]])
           @ np.array([[cx[1], 0, cy[1]], [0, 1, 0], [-cy[1], 0, cx[1]]]))
    d = (d @ rot.T).astype(np.float32)
    o = np.broadcast_to(np.array([0.02, -0.01, -1.6 * bound], np.float32),
                        d.shape).copy()
    return o, d


def _to_t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def test_march_config_properties():
    for kw in ({}, {"bound": 2.0, "grid_size": 64}, {"dt_gamma": 1 / 128}):
        a, b = jm.MarchConfig(**kw), tm.MarchConfig(**kw)
        assert a == dataclasses.replace(a) and dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.cascades, a.dt_min, a.dt_max) == (b.cascades, b.dt_min, b.dt_max)
        for x, y in zip(a.ladder + a.coarse_gamma_ladder, b.ladder + b.coarse_gamma_ladder):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_near_far_aabb(bound):
    o, d = camera_rays(16, bound)
    d[0] = [0.0, 0.0, 1.0]  # axis-aligned ray: the 1e-9 guard
    nj, fj = jm.near_far_aabb(jnp.asarray(o), jnp.asarray(d), bound, 0.2)
    nt, ft = tm.near_far_aabb(_to_t(o), _to_t(d), bound, 0.2)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bound,grid", [(1.0, 32), (2.0, 32), (2.0, 128)])
def test_ladder_plans(bound, grid):
    _, occs = shell_occupancy(grid, 1 + int(np.ceil(np.log2(bound))))
    for kw in ({}, {"coarse_normalized": False}, {"phase_a_group": 5}):
        a = jm.MarchConfig(bound=bound, grid_size=grid, **kw)
        b = tm.MarchConfig(bound=bound, grid_size=grid, **kw)
        assert jm.full_ladder_steps(a) == tm.full_ladder_steps(b)
        assert jm.phase_a_group_of(a) == tm.phase_a_group_of(b)
        assert jm.plan_occupied_ladder(occs, a) == tm.plan_occupied_ladder(occs, b)
        aabb_a, t_a = jm.plan_occupied_crop(occs, a)
        aabb_b, t_b = tm.plan_occupied_crop(occs, b)
        assert t_a == t_b
        np.testing.assert_array_equal(aabb_a, aabb_b)
    empty = np.zeros_like(occs)
    assert tm.plan_occupied_ladder(empty, b) == 0


def test_compact_idx_exact():
    rng = np.random.default_rng(3)
    occ = rng.random((64, 40)) < 0.3
    occ[0] = False
    occ[1] = True
    for k, spread in ((8, True), (8, False), (48, True)):
        ij, vj, sj = jm._compact_idx(jnp.asarray(occ), k, spread)
        it, vt, st = tm._compact_idx(_to_t(occ), k, spread)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_block_coords_and_grouped_test_exact():
    occ, _ = shell_occupancy(32, 2)
    cfg_j = jm.MarchConfig(bound=2.0, grid_size=32)
    cfg_t = tm.MarchConfig(bound=2.0, grid_size=32)
    rng = np.random.default_rng(1)
    pos = rng.uniform(-2.0, 2.0, size=(48, 24, 3)).astype(np.float32)
    dt = rng.uniform(0.005, 0.2, size=(48, 1)).astype(np.float32)
    for dts_j, dts_t in ((cfg_j.dt_min, cfg_t.dt_min), (jnp.asarray(dt), _to_t(dt))):
        fj, lj = jm._block_coords(jnp.asarray(pos), dts_j, 32, cfg_j)
        ft, lt = tm._block_coords(_to_t(pos), dts_t, 32, cfg_t)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        tbl = occ["blocks"].reshape(-1, 2)
        for g, anchors in ((1, None), (4, None), (8, None), (8, [0, 7])):
            oj = jm._grouped_block_test(jnp.asarray(tbl), fj, lj, g, anchors)
            ot = tm._grouped_block_test(_to_t(tbl.astype(np.int64)), ft, lt, g,
                                        anchors)
            np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_dilate_blocks_coarse_exact():
    occ, _ = shell_occupancy(64, 2)
    bc = occ["blocks_coarse"]
    dj = np.asarray(jm.dilate_blocks_coarse(jnp.asarray(bc), 16, 8))
    dt = tm.dilate_blocks_coarse(_to_t(bc.astype(np.int64)), 16, 8)
    np.testing.assert_array_equal(dt.numpy(), dj.astype(np.int64))


def test_beam_contract_violation():
    _, d = camera_rays(32, 2.0)
    for beam in (1, 4, 8, 16):
        a = jm.MarchConfig(bound=2.0, grid_size=32, beam=beam)
        b = tm.MarchConfig(bound=2.0, grid_size=32, beam=beam)
        assert tm.beam_contract_violation(_to_t(d), b) == pytest.approx(
            jm.beam_contract_violation(d, a), rel=1e-12)


_GROUPED = jm._grouped_block_test
_COMPACT = jax.jit(jm._compact_idx, static_argnums=(1, 2))
_SELECT = jax.jit(jm._select_minor, static_argnums=(2,))
_BLOCK_TEST = jax.jit(
    lambda t, f, l, g, a: _GROUPED(t, f, l, g, None if a is None else list(a)),
    static_argnums=(3, 4))


def _jit_exact_helpers(monkeypatch):
    """Run the JAX march's integer and select-only helpers (compaction,
    anchored block-bit test, minor-axis select) jitted: their results are
    exact either way, and a few compiles replace ~80 op-by-op ones. The
    float geometry around them stays op by op."""
    monkeypatch.setattr(jm, "_compact_idx",
                        lambda occ, k, spread=True, **kw: _COMPACT(occ, k, spread))
    monkeypatch.setattr(jm, "_select_minor", _SELECT)
    monkeypatch.setattr(
        jm, "_grouped_block_test",
        lambda t, f, l, g, anchors=None: _BLOCK_TEST(
            t, f, l, g, None if anchors is None else tuple(anchors)))


@pytest.mark.parametrize("beam", [1, 8])
@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_march_rays_block_matches(beam, bound, monkeypatch):
    """The eval marcher (uniform normalized ladder, 2 anchors, beam 1 and 8):
    valid exact, z/dt to rtol 1e-6. The ladder length and run length are
    pinned (their planners are held in test_ladder_plans) so the four cases
    share array shapes and the op-by-op JAX march compiles once."""
    grid = 32
    cascades = 1 + int(np.ceil(np.log2(bound)))
    occ, _ = shell_occupancy(grid, cascades)
    kw = dict(bound=bound, grid_size=grid, max_steps=256, samples_per_ray=8,
              min_near=0.05, coarse_segments=12, coarse_anchors=2, beam=beam,
              t_a0_steps=24, phase_a_group=4)
    cfg_j, cfg_t = jm.MarchConfig(**kw), tm.MarchConfig(**kw)
    o, d = camera_rays(16, bound, focal=20.0)
    occ_j = {k: jnp.asarray(v) for k, v in occ.items()}
    occ_t = occupancy_from_numpy(occ, device="cpu")
    if beam > 1:
        occ_t["blocks_coarse_dilated"] = tm.dilate_blocks_coarse(
            occ_t["blocks_coarse"], grid // 4, 4)  # held in test_dilate_*
        occ_j["blocks_coarse_dilated"] = jnp.asarray(
            occ_t["blocks_coarse_dilated"].numpy().astype(np.uint32))
    # op by op: under jit, XLA contracts multiply-adds into FMAs and moves
    # samples by an ulp (the port matches the unfused arithmetic bit for bit)
    _jit_exact_helpers(monkeypatch)
    mj = jm.march(jnp.asarray(o), jnp.asarray(d), occ_j, cfg_j)
    mt = tm.march(_to_t(o), _to_t(d), occ_t, cfg_t)
    vj = np.asarray(mj["valid"])
    assert vj.sum() > 100  # the frame sees geometry
    np.testing.assert_array_equal(mt["valid"].numpy(), vj)
    for key in ("z", "dt"):
        np.testing.assert_allclose(mt[key].numpy(), np.asarray(mj[key]),
                                   rtol=1e-6, atol=0)
    for key in ("near", "far"):
        np.testing.assert_allclose(mt[key].numpy(), np.asarray(mj[key]),
                                   rtol=0, atol=1e-5)


def test_ray_hash_u_exact():
    """The per-ray stride-phase hash, bit for bit, on directions whose float
    bits span the whole uint32 range."""
    _, d = camera_rays(16, 1.0)
    d = np.concatenate([d, -d, np.random.default_rng(2).normal(size=(64, 3))]).astype(np.float32)
    np.testing.assert_array_equal(tm._ray_hash_u(_to_t(d)).numpy(),
                                  np.asarray(jm._ray_hash_u(jnp.asarray(d))))


_COMPACT_KEYED = jax.jit(
    lambda occ, key, phase_u, k, spread, f=jm._compact_idx: f(
        occ, k, spread, key=key, phase_u=phase_u),
    static_argnums=(3, 4))


@pytest.mark.parametrize("dt_mult", [1, 8])
@pytest.mark.parametrize("stride_phase", ["random", "ray_hash"])
def test_march_with_key_matches(stride_phase, dt_mult, monkeypatch):
    """The training march: the fixed phase-A ladder with 3 anchors, the
    annealed step (max_steps // dt_mult, at least 8), a random start and a
    stratified or per-ray-hash stride phase. The JAX march draws from its
    key; the port gets the same draws as a MarchKey. valid exact, z/dt to
    rtol 1e-6."""
    bound, grid = 2.0, 32
    occ, _ = shell_occupancy(grid, 2)
    kw = dict(bound=bound, grid_size=grid, max_steps=max(256 // dt_mult, 8),
              samples_per_ray=8, min_near=0.05, coarse_segments=16, coarse_anchors=3,
              coarse_normalized=False, stride_phase=stride_phase)
    cfg_j, cfg_t = jm.MarchConfig(**kw), tm.MarchConfig(**kw)
    o, d = camera_rays(16, bound, focal=20.0, seed=dt_mult)
    key = jax.random.PRNGKey(dt_mult)
    k_start, k_phase = jax.random.split(key)
    mkey = tm.MarchKey(
        u=_to_t(jax.random.uniform(k_start, (o.shape[0],))),
        phase=_to_t(jax.random.randint(k_phase, (o.shape[0], 1), 0, 2**30)).long())
    _jit_exact_helpers(monkeypatch)
    monkeypatch.setattr(
        jm, "_compact_idx",
        lambda occ, k, spread=True, key=None, phase_u=None, **kw: _COMPACT_KEYED(
            occ, key, phase_u, k, spread))
    mj = jm.march(jnp.asarray(o), jnp.asarray(d), {k: jnp.asarray(v) for k, v in occ.items()},
                  cfg_j, key=key)
    mt = tm.march(_to_t(o), _to_t(d), occupancy_from_numpy(occ, device="cpu"), cfg_t,
                  key=mkey)
    vj = np.asarray(mj["valid"])
    assert vj.sum() > 100 and (np.asarray(mj["dt"]).max(1) > cfg_j.dt_min * 1.5).any()
    np.testing.assert_array_equal(mt["valid"].numpy(), vj)
    for k in ("z", "dt"):
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), rtol=1e-6, atol=0)
    unkeyed = tm.march(_to_t(o), _to_t(d), occupancy_from_numpy(occ, device="cpu"), cfg_t)
    assert not torch.equal(unkeyed["z"], mt["z"])  # the key moved the samples


def test_march_config_gamma_and_plan_gamma_span():
    """plan_gamma_span against the reference on the shell occupancy, bound 1
    and 2; an empty grid plans 0."""
    for bound, grid in ((1.0, 32), (2.0, 32), (2.0, 128)):
        _, occs = shell_occupancy(grid, 1 + int(np.ceil(np.log2(bound))))
        a = jm.MarchConfig(bound=bound, grid_size=grid, dt_gamma=1 / 128)
        b = tm.MarchConfig(bound=bound, grid_size=grid, dt_gamma=1 / 128)
        span = tm.plan_gamma_span(occs, b)
        assert 0.0 < span == jm.plan_gamma_span(occs, a)
        for x, y in zip(dataclasses.replace(a, gamma_span=span).coarse_gamma_ladder,
                        dataclasses.replace(b, gamma_span=span).coarse_gamma_ladder):
            np.testing.assert_array_equal(x, y)
    assert tm.plan_gamma_span(np.zeros_like(occs), b) == 0.0


def test_crop_near_far():
    """crop_near_far and near_far_aabb with a crop AABB: within 1e-5; rays
    that miss the crop get far == near."""
    o, d = camera_rays(16, 1.0)
    crop = np.asarray([-0.3, -0.5, -0.2, 0.4, 0.1, 0.6], np.float32)
    nj, fj = jm.near_far_aabb(jnp.asarray(o), jnp.asarray(d), 1.0, 0.2, jnp.asarray(crop))
    nt, ft = tm.near_far_aabb(_to_t(o), _to_t(d), 1.0, 0.2, _to_t(crop))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-5)
    assert 0 < int((ft == nt).sum()) < len(o)


@pytest.mark.parametrize("case", ["eval_beam8", "train_key", "crop"])
def test_march_gamma_matches(case, monkeypatch):
    """The static gamma ladder (dt_gamma 1/128) at bound 1: the eval march
    (normalized, 2 anchors, beam 8), the keyed training march (fixed ladder,
    3 anchors) and a march inside a crop AABB, against the JAX march run op
    by op (its static-row selects and integer helpers jitted: exact either
    way). valid exact, z/dt to rtol 1e-6. The fine test's cascade rides each
    segment's own step here, so a sample with dt near a cascade's edge would
    show a different valid mask."""
    grid, bound = 32, 1.0
    occ, _ = shell_occupancy(grid, 1)
    kw = dict(bound=bound, grid_size=grid, max_steps=256, samples_per_ray=8,
              min_near=0.05, dt_gamma=1 / 128, coarse_segments=12, coarse_anchors=2)
    key = mkey = crop = None
    o, d = camera_rays(16, bound, focal=20.0)
    occ_j = {k: jnp.asarray(v) for k, v in occ.items()}
    occ_t = occupancy_from_numpy(occ, device="cpu")
    if case == "eval_beam8":
        kw["beam"] = 8
        occ_t["blocks_coarse_dilated"] = tm.dilate_blocks_coarse(
            occ_t["blocks_coarse"], grid // 4, 4)
        occ_j["blocks_coarse_dilated"] = jnp.asarray(
            occ_t["blocks_coarse_dilated"].numpy().astype(np.uint32))
    elif case == "train_key":
        kw.update(coarse_normalized=False, coarse_segments=16, coarse_anchors=3)
        key = jax.random.PRNGKey(3)
        k_start, k_phase = jax.random.split(key)
        mkey = tm.MarchKey(
            u=_to_t(jax.random.uniform(k_start, (o.shape[0],))),
            phase=_to_t(jax.random.randint(k_phase, (o.shape[0], 1), 0, 2**30)).long())
    else:
        crop = np.asarray([-0.6, -0.6, -0.3, 0.5, 0.6, 0.7], np.float32)
    cfg_j, cfg_t = jm.MarchConfig(**kw), tm.MarchConfig(**kw)
    _jit_exact_helpers(monkeypatch)
    monkeypatch.setattr(
        jm, "_compact_idx",
        lambda occ_, k, spread=True, key=None, phase_u=None, **kw_: _COMPACT_KEYED(
            occ_, key, phase_u, k, spread))
    monkeypatch.setattr(jm, "_select_static_row",
                        lambda row, sel: jnp.asarray(np.asarray(row, np.float32))[sel])
    mj = jm.march(jnp.asarray(o), jnp.asarray(d), occ_j, cfg_j, key=key,
                  crop_aabb=None if crop is None else jnp.asarray(crop))
    mt = tm.march(_to_t(o), _to_t(d), occ_t, cfg_t, key=mkey,
                  crop_aabb=None if crop is None else _to_t(crop))
    vj = np.asarray(mj["valid"])
    assert vj.sum() > 100
    np.testing.assert_array_equal(mt["valid"].numpy(), vj)
    for k in ("z", "dt"):
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), rtol=1e-6, atol=0)
    dts = np.asarray(mj["dt"])[vj]
    assert dts.max() > 2.0 * dts.min()  # the steps grow along the ladder
