"""The march and occupancy options of nerfnav_tpu_torch vs the JAX package's,
on the CPU: the lookups, proxy termination, first-K compaction, depth
windows, the byte-bitfield marchers, the block marcher's options (phase A0,
first-K, segment-level proxy termination, stop_after, the injected phase
A), march_segments, the dispatcher and the autotuner's candidates.

The same rays and occupancy (numpy, from a seed) go through both packages.
Valid masks and indices must match exactly, z/dt to rtol 1e-6. The JAX
marchers run op by op, their integer and select-only helpers jitted (exact
either way): under jit XLA contracts multiply-adds into FMAs and can move a
sample across a cell boundary (tests/test_torch_march.py).
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
from test_torch_march import _jit_exact_helpers, _pack_blocks_np, _to_t, camera_rays

torch.set_num_threads(1)

_COMPACT = jax.jit(
    lambda occ, key, phase_u, k, spread, align_end, f=jm._compact_idx: f(
        occ, k, spread, key=key, align_end=align_end, phase_u=phase_u),
    static_argnums=(3, 4, 5))


def _exact_helpers(monkeypatch):
    """_jit_exact_helpers, with the compaction's key, phase_u and align_end
    (the first-K hybrid's tail) passed through."""
    _jit_exact_helpers(monkeypatch)
    monkeypatch.setattr(
        jm, "_compact_idx",
        lambda occ, k, spread=True, key=None, align_end=False, phase_u=None: _COMPACT(
            occ, key, phase_u, k, spread, align_end))


def _scene(grid, bound, shape="sphere", coarse_block=4, seed=0):
    """Numpy occupancy tables in the JAX package's layouts (test_marching.py's
    scenes): "sphere" (radius 0.55 x cascade bound), "fence" (thin z slabs
    three coarse cells apart), "shell" (a shell of radius 0.4-0.55), "slab"
    (a thick wall across z, cascade 0) or "random" (3% speckle); with a
    density grid and its min-pooled coarse table (density 500 where
    occupied)."""
    cascades = jm.MarchConfig(bound=bound).cascades
    h, f = grid, 4
    hc = h // f
    idx = np.arange(h**3)
    c = (np.stack([idx // (h * h), (idx // h) % h, idx % h], -1) + 0.5) / h * 2 - 1
    occs = []
    for cas in range(cascades):
        cb = min(2.0**cas, bound)
        if shape == "sphere":
            occs.append(np.linalg.norm(c * cb, axis=-1) < 0.55 * cb)
        elif shape == "fence":
            occs.append(((c[:, 2] + 1) * 0.5 * h).astype(int) % (3 * f) == 0)
        elif shape == "shell":
            r = np.linalg.norm(c, axis=-1)
            occs.append((r > 0.4) & (r < 0.55))
        elif shape == "slab":
            occs.append((c[:, 2] * cb > -0.2) & (c[:, 2] * cb < 0.9) & (cas == 0))
        else:
            occs.append(np.random.default_rng(seed + cas).uniform(size=h**3) < 0.03)
    occs = np.stack(occs)
    occ_c = occs.reshape(-1, hc, f, hc, f, hc, f).max(axis=(2, 4, 6)).reshape(cascades, -1)
    grid_d = np.where(occs, 500.0, 0.0).astype(np.float32)
    dmin = grid_d.reshape(-1, hc, f, hc, f, hc, f).min(axis=(2, 4, 6)).reshape(cascades, -1)
    return {
        "bitfield": np.packbits(occs, axis=-1, bitorder="little"),
        "bitfield_coarse": np.packbits(occ_c, axis=-1, bitorder="little"),
        "blocks": _pack_blocks_np(occs, h, 4),
        "blocks_coarse": _pack_blocks_np(occ_c, hc, coarse_block),
        "density_grid": grid_d,
        "density_coarse_min": dmin,
    }


def _rays(bound, seed=0):
    """The 64 rays of an 8x8 frame looking at the origin from -1.6 bound
    (test_torch_march.py's camera): every case marches this one shape, so
    the op-by-op JAX march compiles each of its ops once per file."""
    return camera_rays(8, bound, focal=10.0, seed=seed)


def _both(occ, keys):
    return ({k: jnp.asarray(occ[k]) for k in keys},
            occupancy_from_numpy({k: occ[k] for k in keys}, device="cpu"))


def _assert_march_equal(mt, mj, min_valid=1):
    vj = np.asarray(mj["valid"])
    assert vj.sum() >= min_valid
    np.testing.assert_array_equal(mt["valid"].numpy(), vj)
    for k in ("z", "dt"):
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), rtol=1e-6, atol=0)


def _key(n, seed):
    """A JAX march key and the port's MarchKey of its draws."""
    key = jax.random.PRNGKey(seed)
    k_start, k_phase = jax.random.split(key)
    return key, tm.MarchKey(
        u=_to_t(jax.random.uniform(k_start, (n,))),
        phase=_to_t(jax.random.randint(k_phase, (n, 1), 0, 2**30)).long())


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_lookups_exact(bound):
    """occupancy_lookup and density_lookup at random positions with a
    static step and with per-position steps: bits and values exactly."""
    occ = _scene(32, bound, shape="random")
    cfg_j = jm.MarchConfig(bound=bound, grid_size=32)
    cfg_t = tm.MarchConfig(bound=bound, grid_size=32)
    rng = np.random.default_rng(1)
    pos = rng.uniform(-bound, bound, (64, 40, 3)).astype(np.float32)
    dt = rng.uniform(0.001, 0.3, (64, 40)).astype(np.float32)
    bits = 0
    for dj, dtt in ((cfg_j.dt_min, cfg_t.dt_min), (jnp.asarray(dt), _to_t(dt))):
        oj = np.asarray(jm.occupancy_lookup(jnp.asarray(occ["bitfield"]), jnp.asarray(pos),
                                            dj, cfg_j))
        ot = tm.occupancy_lookup(_to_t(occ["bitfield"]), _to_t(pos), dtt, cfg_t)
        np.testing.assert_array_equal(ot.numpy(), oj)
        bits += oj.sum()
        gj = jm.density_lookup(jnp.asarray(occ["density_grid"]), jnp.asarray(pos), dj, cfg_j)
        gt = tm.density_lookup(_to_t(occ["density_grid"]), _to_t(pos), dtt, cfg_t)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert bits > 0


def test_apply_z_window():
    o, d = camera_rays(8, 1.0)
    nt, ft = tm.near_far_aabb(_to_t(o), _to_t(d), 1.0, 0.05)
    nj, fj = jnp.asarray(nt.numpy()), jnp.asarray(ft.numpy())
    lo = np.random.default_rng(0).uniform(0.5, 1.5, len(o)).astype(np.float32)
    for win_j, win_t in (((1.2, 2.0), (1.2, 2.0)), ((0.0, 100.0), (0.0, 100.0)),
                         ((jnp.asarray(lo), jnp.asarray(lo + 0.3)), (_to_t(lo), _to_t(lo + 0.3)))):
        a = jm.apply_z_window(nj, fj, win_j)
        b = tm.apply_z_window(nt, ft, win_t)
        for x, y in zip(b, a):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert tm.apply_z_window(nt, ft, None) == (nt, ft)


@pytest.mark.parametrize("mode", ["spread", "first", "hybrid", "hybrid_key", "hybrid_hash",
                                  "hybrid_all_front", "short_lattice"])
def test_compact_first_k_exact(mode):
    """_compact_first_k (its gathers and the stride-scaled dt) and the first-K
    hybrid (front section, end-aligned or keyed tail): valid and indices
    exactly, z/dt exactly."""
    rng = np.random.default_rng(4)
    n, t, k = 48, 40, 8
    occ = rng.random((n, t)) < 0.35
    occ[0] = False
    occ[1] = True
    z = np.cumsum(rng.uniform(0.01, 0.05, (n, t)), 1).astype(np.float32)
    dtv = rng.uniform(0.01, 0.05, (1, t)).astype(np.float32)
    key = phase_u = None
    frac = 0.75
    if mode == "short_lattice":
        occ, z, dtv, k = occ[:, :6], z[:, :6], dtv[:, :6], 8
    if mode == "hybrid_key":
        key = jax.random.PRNGKey(5)
    if mode == "hybrid_hash":
        phase_u = rng.random(n).astype(np.float32)
    if mode == "hybrid_all_front":
        frac = 1.0
    first = None if mode in ("spread", "first", "short_lattice") else frac
    spread = mode != "first"
    zj, dj, vj = jm._compact_first_k(jnp.asarray(occ), jnp.asarray(z), jnp.asarray(dtv), k,
                                     spread, key=key, first_frac=first,
                                     phase_u=None if phase_u is None else jnp.asarray(phase_u))
    phase = None if key is None else _to_t(jax.random.randint(key, (n, 1), 0, 2**30)).long()
    zt, dt_, vt = tm._compact_first_k(_to_t(occ), _to_t(z), _to_t(dtv), k, spread,
                                      phase=phase, first_frac=first,
                                      phase_u=None if phase_u is None else _to_t(phase_u))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(dt_.numpy(), np.asarray(dj))
    if first is not None:
        ij, vj2, sj = jm._compact_idx_hybrid(jnp.asarray(occ), k, frac, key=key)
        it, vt2, st = tm._compact_idx_hybrid(_to_t(occ), k, frac, phase=phase)
        for a, b in ((it, ij), (vt2, vj2), (st, sj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ij, vj, sj = jm._compact_idx(jnp.asarray(occ), 3, align_end=True)
    it, vt, st = tm._compact_idx(_to_t(occ), 3, align_end=True)
    for a, b in ((it, ij), (vt, vj), (st, sj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("coarse", [False, True])
def test_proxy_terminate_valid_exact(coarse):
    """proxy_terminate_valid on a march of the sphere, against the EMA grid
    or the min-pooled coarse table (its own grid size): the mask exactly, a
    prefix of each ray's valid samples."""
    occ = _scene(32, 1.0, shape="slab")
    cfg_kw = dict(bound=1.0, grid_size=32, max_steps=256, samples_per_ray=16, min_near=0.05,
                  proxy_thresh=1e-3)
    o, d = _rays(1.0)
    m = tm.march_rays(_to_t(o), _to_t(d), _to_t(occ["bitfield"]), tm.MarchConfig(**cfg_kw))
    table = occ["density_coarse_min" if coarse else "density_grid"]
    gs = 8 if coarse else None
    vt = tm.proxy_terminate_valid(m, _to_t(o), _to_t(d), _to_t(table), tm.MarchConfig(**cfg_kw),
                                  grid_size=gs)
    mj = {k: jnp.asarray(v.numpy()) for k, v in m.items()}
    vj = np.asarray(jm.proxy_terminate_valid(mj, jnp.asarray(o), jnp.asarray(d),
                                             jnp.asarray(table), jm.MarchConfig(**cfg_kw),
                                             grid_size=gs))
    np.testing.assert_array_equal(vt.numpy(), vj)
    assert 0 < vj.sum() < m["valid"].sum()


# ------------------------------------------------------- byte-bitfield marchers
BYTE_CASES = {
    # test_marching.py's TestMarch, TestTwoPhase, TestGammaMarch (dt_gamma
    # 1/64 on the fixed ladder, bound 2) and TestFirstKHybrid, at one grid
    # and budget
    "single": (dict(bound=1.0), "single", "sphere"),
    "single_gamma": (dict(bound=2.0, dt_gamma=1 / 64, coarse_normalized=False), "single",
                     "sphere"),
    "single_first_k": (dict(bound=1.0, first_k=True), "single", "shell"),
    "two_phase": (dict(bound=1.0), "two_phase", "sphere"),
    "two_phase_fixed": (dict(bound=2.0, coarse_normalized=False), "two_phase", "random"),
    "two_phase_gamma": (dict(bound=2.0, dt_gamma=1 / 64, coarse_normalized=False),
                        "two_phase", "sphere"),
    "two_phase_first_k": (dict(bound=1.0, first_k=True), "two_phase", "shell"),
}
GRID_KW = dict(grid_size=32, max_steps=256, samples_per_ray=16, min_near=0.05)


@pytest.mark.parametrize("case", sorted(BYTE_CASES))
@pytest.mark.parametrize("keyed", [False, True])
def test_byte_marchers_match(case, keyed, monkeypatch):
    """march_rays and march_rays_two_phase on the fixed, normalized and gamma
    ladders, with the first-K hybrid, unkeyed and keyed (a random start and
    a stratified stride phase): valid exact, z/dt to rtol 1e-6."""
    kw, marcher, shape = BYTE_CASES[case]
    kw = dict(GRID_KW, **kw)
    bound = kw["bound"]
    occ = _scene(32, bound, shape=shape)
    o, d = _rays(bound, seed=len(case))
    cfg_j, cfg_t = jm.MarchConfig(**kw), tm.MarchConfig(**kw)
    key, mkey = _key(len(o), 7) if keyed else (None, None)
    _exact_helpers(monkeypatch)
    if marcher == "single":
        mj = jm.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ["bitfield"]),
                           cfg_j, key=key)
        mt = tm.march_rays(_to_t(o), _to_t(d), _to_t(occ["bitfield"]), cfg_t, key=mkey)
    else:
        mj = jm.march_rays_two_phase(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(occ["bitfield"]),
                                     jnp.asarray(occ["bitfield_coarse"]), cfg_j, key=key)
        mt = tm.march_rays_two_phase(_to_t(o), _to_t(d), _to_t(occ["bitfield"]),
                                     _to_t(occ["bitfield_coarse"]), cfg_t, key=mkey)
    _assert_march_equal(mt, mj, min_valid=100)


@pytest.mark.parametrize("marcher", ["single", "two_phase", "block"])
def test_z_window_identity_and_bounds(marcher, monkeypatch):
    """test_marching.py::test_z_window_identity_and_bounds on each marcher: a
    window over the whole span reproduces the unwindowed march exactly, a
    tight one (per-ray tensors) confines every sample; both equal the JAX
    march."""
    bound = 1.0
    kw = dict(GRID_KW, bound=bound)
    occ = _scene(32, bound)
    occ_j, occ_t = _both(occ, {"single": ["bitfield"],
                               "two_phase": ["bitfield", "bitfield_coarse"],
                               "block": ["bitfield", "blocks", "blocks_coarse"]}[marcher])
    o, d = _rays(bound, seed=1)
    cfg_j, cfg_t = jm.MarchConfig(**kw), tm.MarchConfig(**kw)
    _exact_helpers(monkeypatch)
    m0 = tm.march(_to_t(o), _to_t(d), occ_t, cfg_t)
    m_full = tm.march(_to_t(o), _to_t(d), occ_t, cfg_t, z_window=(0.0, 100.0))
    np.testing.assert_array_equal(m_full["valid"].numpy(), m0["valid"].numpy())
    np.testing.assert_array_equal(m_full["z"].numpy(), m0["z"].numpy())
    lo = np.full(len(o), 1.2 * bound, np.float32)
    win = (lo, lo + 0.2 * bound)
    mj = jm.march(jnp.asarray(o), jnp.asarray(d), occ_j, cfg_j,
                  z_window=tuple(jnp.asarray(w) for w in win))
    mt = tm.march(_to_t(o), _to_t(d), occ_t, cfg_t, z_window=tuple(_to_t(w) for w in win))
    _assert_march_equal(mt, mj, min_valid=30)
    z = mt["z"][mt["valid"]]
    assert z.min() >= win[0][0] - 1e-5 and z.max() <= win[1][0] + 1e-5
    assert mt["valid"].sum() < m0["valid"].sum()


# --------------------------------------------------------- block options
BLOCK_CASES = {
    # name: (config, scene, coarse block edge); test_marching.py's
    # TestBlockMarch (a0), TestFirstKHybrid, TestProxyTerminate
    # (candidate_level_concentrates_budget: a thick wall, a tight budget)
    "a0_b1": (dict(bound=1.0, a0_segments=6), "sphere", 4),
    "a0_b2_bc8": (dict(bound=2.0, a0_segments=6), "sphere", 8),
    "a0_overflow": (dict(bound=1.0, a0_segments=2), "fence", 4),
    "coarse_first_k": (dict(bound=1.0, coarse_first_k=True, coarse_segments=4), "fence", 4),
    "first_k": (dict(bound=1.0, first_k=True), "shell", 8),
    "proxy": (dict(bound=1.0, samples_per_ray=8, proxy_terminate=True), "slab", 4),
    "stop_phase_b_occ": (dict(bound=1.0), "sphere", 4),
    "stop_phase_a": (dict(bound=1.0, beam=4), "sphere", 4),
    "proxy_beam4": (dict(bound=1.0, proxy_terminate=True, beam=4), "slab", 4),
    "a0_proxy_beam4": (dict(bound=1.0, proxy_terminate=True, beam=4, a0_segments=6),
                       "slab", 4),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_options_match(case, monkeypatch):
    """march_rays_block with phase A0 (test_a0_keeps_byte_marcher_samples,
    test_a0_stride_overflow_no_holes), the first-K compactions, the
    segment-level proxy termination (its 3^3 min-pooled table under a beam)
    and the stop_after hooks: valid exact, z/dt to rtol 1e-6."""
    kw, shape, cb = BLOCK_CASES[case]
    kw = dict(GRID_KW, **kw)
    bound = kw["bound"]
    occ = _scene(32, bound, shape=shape, coarse_block=cb)
    keys = ["bitfield", "blocks", "blocks_coarse", "density_coarse_min"]
    occ_j, occ_t = _both(occ, keys)
    o, d = _rays(bound)
    cfg_j, cfg_t = jm.MarchConfig(**kw), tm.MarchConfig(**kw)
    stop = {"stop_phase_a": "phase_a", "stop_phase_b_occ": "phase_b_occ"}.get(case, "")
    _exact_helpers(monkeypatch)
    mj = jm.march(jnp.asarray(o), jnp.asarray(d), occ_j, cfg_j, stop_after=stop)
    mt = tm.march(_to_t(o), _to_t(d), occ_t, cfg_t, stop_after=stop)
    _assert_march_equal(mt, mj, min_valid=100)
    if stop == "phase_a":
        assert mt["z"].shape == (len(o), kw.get("coarse_segments", 16))
    if kw.get("proxy_terminate"):
        off = tm.march(_to_t(o), _to_t(d), occ_t, dataclasses.replace(cfg_t,
                                                                       proxy_terminate=False))
        assert mt["valid"].sum() < off["valid"].sum()  # the proxy ended some rays


def test_beam_proxy_conservative(monkeypatch):
    """test_beam_march.py::TestBeamProxyConservative: a member crossing a
    less dense row keeps its samples behind the wall (the proxy is a no-op
    under the beam's min-pooled table), and a thick wall still ends the
    rays; both equal the JAX march."""
    h, f = 32, 4
    hc = h // f
    cfg_kw = dict(GRID_KW, bound=1.0, beam=4)
    # the reference's beam of 4, repeated to the other cases' 64 rays
    o = np.tile(np.float32([[0.0, 0.0, -1.5]]), (64, 1))
    a = np.tile(np.array([-1.0 / 12, 1.0 / 36, 1.0 / 12, 5.0 / 36], np.float32), 16)
    d = np.stack([np.zeros(64, np.float32), a, np.ones(64, np.float32)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    occ = np.ones((1, h**3), bool)
    occ_c = np.ones((1, hc**3), bool)
    _exact_helpers(monkeypatch)
    for wall_y_min, wall_z in ((4, (3, 5)), (0, (2, 6))):
        dmin = np.zeros((1, hc, hc, hc), np.float32)
        dmin[0, :, wall_y_min:, wall_z[0]:wall_z[1]] = 500.0
        tables = {"bitfield": np.packbits(occ, axis=-1, bitorder="little"),
                  "blocks": _pack_blocks_np(occ, h, 4),
                  "blocks_coarse": _pack_blocks_np(occ_c, hc, 4),
                  "density_coarse_min": dmin.reshape(1, -1)}
        occ_j, occ_t = _both(tables, list(tables))
        on_j = jm.march(jnp.asarray(o), jnp.asarray(d), occ_j,
                        jm.MarchConfig(**cfg_kw, proxy_terminate=True))
        on = tm.march(_to_t(o), _to_t(d), occ_t, tm.MarchConfig(**cfg_kw, proxy_terminate=True))
        off = tm.march(_to_t(o), _to_t(d), occ_t, tm.MarchConfig(**cfg_kw))
        _assert_march_equal(on, on_j, min_valid=20)
        z = on["z"][on["valid"]]
        if wall_y_min == 4:
            np.testing.assert_array_equal(on["valid"].numpy(), off["valid"].numpy())
            assert -1.5 + float(on["z"][0][on["valid"][0]].max()) > 0.3
        else:
            assert on["valid"].sum() < off["valid"].sum() and -1.5 + float(z.max()) < 0.55


# ------------------------------------------------------- frame-level phase A
@pytest.mark.parametrize("beam", [1, 4])
def test_frame_phase_a_split(beam, monkeypatch):
    """test_beam_march.py::TestFramePhaseASplit: one stop_after="phase_a"
    march of 64 rays, consumed by two 32-ray chunks as phase_a, equals the
    fused march bit for bit; phase A and the chunks equal the JAX ones."""
    kw = dict(GRID_KW, bound=1.0, beam=beam)
    occ = _scene(32, 1.0)
    occ_j, occ_t = _both(occ, ["bitfield", "blocks", "blocks_coarse"])
    o, d = _rays(1.0)
    cfg_j, cfg_t = jm.MarchConfig(**kw), tm.MarchConfig(**kw)
    m_ref = tm.march(_to_t(o), _to_t(d), occ_t, cfg_t)
    ma = tm.march(_to_t(o), _to_t(d), occ_t, cfg_t, stop_after="phase_a")
    _exact_helpers(monkeypatch)
    ma_j = jm.march(jnp.asarray(o), jnp.asarray(d), occ_j, cfg_j, stop_after="phase_a")
    _assert_march_equal(ma, ma_j, min_valid=20)
    outs = []
    for i in range(0, 64, 32):
        pa = {k: ma[k][i : i + 32] for k in ("z", "dt", "valid")}
        outs.append(tm.march(_to_t(o[i : i + 32]), _to_t(d[i : i + 32]), occ_t, cfg_t,
                             phase_a=pa))
    for k in ("z", "dt", "valid"):
        np.testing.assert_array_equal(torch.cat([m[k] for m in outs]).numpy(),
                                      m_ref[k].numpy(), err_msg=k)
    pa_j = {k: ma_j[k][32:] for k in ("z", "dt", "valid")}
    mj = jm.march(jnp.asarray(o[32:]), jnp.asarray(d[32:]), occ_j, cfg_j, phase_a=pa_j)
    _assert_march_equal(outs[1], mj, min_valid=20)


def test_phase_a_rejected_cases():
    """An injected phase A is refused under dt_gamma > 0 (as in the
    reference) and, diverging from the reference, when the beam does not
    divide the chunk's N: the reference (ops/marching.py:1128) then skips
    the members' z_b >= near mask silently (ROADMAP C). Byte bitfields have
    no phase A to stop after."""
    kw = dict(bound=1.0, grid_size=32, max_steps=256, samples_per_ray=16, min_near=0.05)
    occ = _scene(32, 1.0)
    _, occ_t = _both(occ, ["bitfield", "bitfield_coarse", "blocks", "blocks_coarse"])
    o, d = camera_rays(8, 1.0, focal=8.0)
    pa = {"z": torch.zeros((60, 16)), "dt": torch.zeros((60, 16)),
          "valid": torch.zeros((60, 16), dtype=torch.bool)}
    with pytest.raises(ValueError, match="dt_gamma"):
        tm.march(_to_t(o[:60]), _to_t(d[:60]), occ_t, tm.MarchConfig(**kw, dt_gamma=0.01),
                 phase_a=pa)
    with pytest.raises(ValueError, match="divisible by the beam"):
        tm.march(_to_t(o[:60]), _to_t(d[:60]), occ_t, tm.MarchConfig(**kw, beam=8),
                 phase_a=pa)
    tm.march(_to_t(o[:64]), _to_t(d[:64]), occ_t, tm.MarchConfig(**kw, beam=8),
             phase_a={k: torch.cat([v, v[:4]]) for k, v in pa.items()})
    byte = {k: occ_t[k] for k in ("bitfield", "bitfield_coarse")}
    with pytest.raises(ValueError, match="block marcher"):
        tm.march(_to_t(o), _to_t(d), byte, tm.MarchConfig(**kw), stop_after="phase_a")


# ----------------------------------------------- dispatch, segments, autotune
@pytest.mark.parametrize("tables", ["blocks", "coarse", "grid_only", "bare"])
def test_dispatch_and_proxy_fallback(tables, monkeypatch):
    """march() takes the reference's marcher for the tables it is given
    (march.calls counts it) and, under proxy_terminate, masks the byte
    marchers' samples on density_coarse_min, or on density_grid without it:
    each equal to the JAX march."""
    kw = dict(GRID_KW, bound=1.0, proxy_terminate=True)
    occ = _scene(32, 1.0, shape="slab")
    keys = {"blocks": ["bitfield", "bitfield_coarse", "blocks", "blocks_coarse",
                       "density_grid", "density_coarse_min"],
            "coarse": ["bitfield", "bitfield_coarse", "density_grid", "density_coarse_min"],
            "grid_only": ["bitfield", "density_grid"], "bare": ["bitfield"]}[tables]
    occ_j, occ_t = _both(occ, keys)
    if tables == "bare":
        occ_j, occ_t = occ_j["bitfield"], occ_t["bitfield"]
    o, d = _rays(1.0, seed=3)
    before = dict(tm.march.calls)
    _exact_helpers(monkeypatch)
    mj = jm.march(jnp.asarray(o), jnp.asarray(d), occ_j, jm.MarchConfig(**kw))
    mt = tm.march(_to_t(o), _to_t(d), occ_t, tm.MarchConfig(**kw))
    _assert_march_equal(mt, mj, min_valid=60)
    took = {k for k, v in tm.march.calls.items() if v != before[k]}
    assert took == {{"blocks": "block", "coarse": "two_phase"}.get(tables, "single")}


def test_march_segments_match():
    """march_segments' occupied extent per ray: z_first, z_last and hit
    exactly; a bitfield without its coarse mirror is refused."""
    occ = _scene(32, 1.0)
    cfg_kw = dict(GRID_KW, bound=1.0)
    o, d = camera_rays(8, 1.0, focal=4.0, seed=5)
    for normalized in (True, False):
        kw = dict(cfg_kw, coarse_normalized=normalized)
        sj = jm.march_segments(jnp.asarray(o), jnp.asarray(d),
                               {k: jnp.asarray(occ[k]) for k in ("bitfield", "bitfield_coarse")},
                               jm.MarchConfig(**kw))
        st = tm.march_segments(_to_t(o), _to_t(d), occupancy_from_numpy(
            {k: occ[k] for k in ("bitfield", "bitfield_coarse")}, device="cpu"),
            tm.MarchConfig(**kw))
        for k in ("z_first", "z_last", "hit"):
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))
        assert 0 < int(st["hit"].sum()) < len(o)
    with pytest.raises(ValueError, match="bitfield_coarse"):
        tm.march_segments(_to_t(o), _to_t(d), {"bitfield": _to_t(occ["bitfield"])},
                          tm.MarchConfig(**cfg_kw))


def test_autotune_march_shape(monkeypatch):
    """The autotuner's default candidates are the reference's (its march
    stubbed, so no program is compiled) and it returns the fastest of the
    ones it timed, as a config; it refuses an occupancy without blocks."""
    kw = dict(bound=2.0, grid_size=32, max_steps=256, samples_per_ray=16, min_near=0.05)
    occ = _scene(32, 2.0)
    occ_j, occ_t = _both(occ, ["bitfield", "bitfield_coarse", "blocks", "blocks_coarse"])
    o, d = camera_rays(16, 2.0, focal=20.0)
    monkeypatch.setattr(jm, "march", lambda a, b, occ, cfg, **k: {
        "z": jnp.zeros((1,)), "dt": jnp.zeros((1,)), "valid": jnp.zeros((1,), bool)})
    _, res_j = jm.autotune_march_shape(occ_j, jm.MarchConfig(**kw), jnp.asarray(o),
                                       jnp.asarray(d), chunk=64, iters=1)
    best, res_t = tm.autotune_march_shape(occ_t, tm.MarchConfig(**kw), _to_t(o), _to_t(d),
                                          chunk=64, iters=1)
    assert [r[:2] for r in res_t] == [r[:2] for r in res_j] and len(res_t) >= 3
    g, t, _ = min(res_t, key=lambda r: r[2])
    assert (best.phase_a_group, best.t_a0_steps) == (g, t)
    best, res = tm.autotune_march_shape(occ_t, tm.MarchConfig(**kw), _to_t(o), _to_t(d),
                                        chunk=64, iters=3, candidates=[(4, 32), (3, 27)])
    assert [r[:2] for r in res] == [(4, 32), (3, 27)] and all(r[2] > 0 for r in res)
    with pytest.raises(ValueError, match="block"):
        tm.autotune_march_shape({"bitfield": occ_t["bitfield"]}, tm.MarchConfig(**kw),
                                _to_t(o), _to_t(d))


# ------------------------------------------------------- render_full options
@pytest.mark.parametrize("option", ["first_k", "proxy", "frame_phase_a", "frame_phase_a_beam",
                                    "two_phase", "single"])
def test_render_full_options(option, tmp_path, monkeypatch):
    """Trainer.render_full with --eval_first_k, --eval_proxy (a min-pooled
    density table in the state), eval_frame_phase_a (beam off and AUTO) and
    on occupancy without block tables (the byte two-phase and single-phase
    marchers), xla fp32 field and tables: image and depth within 1e-5 of the
    JAX trainer's, which shades the port's march of its rays
    (test_torch_render.py::_march_by_port; that march takes no frame-level
    split, so the JAX frame is the per-chunk one). The frame-level split
    equals the port's per-chunk render bit for bit."""
    from test_torch_render import _march_by_port, _net_cfg, _trainers

    opt = dict(eval_table_dtype="float32", eval_beam=1)
    if option == "first_k":
        opt["eval_first_k"] = True
    elif option == "proxy":
        opt["eval_proxy"] = True
    elif option.startswith("frame_phase_a"):
        opt["eval_frame_phase_a"] = True
        if option.endswith("beam"):
            opt["eval_beam"] = 4
    tj, tt, pose, intr = _trainers(tmp_path, _net_cfg(), 1.0, opt)
    occ = {k: v for k, v in tt.occupancy.items()
           if not (option in ("two_phase", "single") and k.startswith("blocks")
                   or option == "single" and k == "bitfield_coarse")}
    if option == "proxy":
        grid = np.random.default_rng(3).exponential(30.0, (1, 8**3)).astype(np.float32)
        occ["density_coarse_min"] = torch.as_tensor(grid)
        tj.state = tj.state._replace(occupancy={**tj.state.occupancy,
                                                "density_coarse_min": jnp.asarray(grid)})
    if option in ("two_phase", "single"):
        tj.state = tj.state._replace(occupancy={k: v for k, v in tj.state.occupancy.items()
                                                if k in occ})
    tt.set_occupancy(occ)
    _march_by_port(monkeypatch, tt.occupancy)
    before = dict(tm.march.calls)
    it, dt = tt.render_full(tt.params, pose, intr, 16, 16)
    ij, dj = tj.render_full(tj.params, pose, intr, 16, 16)
    assert (np.asarray(ij) < 0.5).mean() > 0.05
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-5)
    took = {k for k, v in tm.march.calls.items() if v != before[k]}
    assert took == {{"two_phase": "two_phase", "single": "single"}.get(option, "block")}
    if option.startswith("frame_phase_a"):
        tt.opt.eval_frame_phase_a = False
        it2, dt2 = tt.render_full(tt.params, pose, intr, 16, 16)
        assert torch.equal(it, it2) and torch.equal(dt, dt2)
    elif option != "two_phase" and option != "single":
        tt.opt.eval_first_k = tt.opt.eval_proxy = False
        assert not torch.equal(it, tt.render_full(tt.params, pose, intr, 16, 16)[0])
