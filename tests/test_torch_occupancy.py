"""nerfnav_tpu_torch occupancy maintenance vs the JAX package's, on the CPU.

The sweeps draw their jitter and cells from a JAX key; the port gets the same
draws as tensors. density_grid and mean_density agree within 1e-5
(relative); bitfields and block tables exactly, except at a cell whose new
density sits within 1e-5 of the carve bar, where the two frameworks' f32
sums can land on either side: the test counts such cells and holds every
other bit exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfnav_tpu.models import network as jnet
from nerfnav_tpu.models import occupancy as jocc
from nerfnav_tpu.ops import morton as jmorton
from nerfnav_tpu_torch.models import network as tnet
from nerfnav_tpu_torch.models import occupancy as tocc
from nerfnav_tpu_torch.ops import morton as tmorton
from nerfnav_tpu_torch.training.checkpoint import occupancy_from_numpy, params_from_numpy

torch.set_num_threads(1)

NET = dict(bound=2.0, grid_levels=2, grid_level_dim=8, grid_log2_hashmap_size=10,
           grid_max_resolution=32, grid_layout="cell", density_scale=3.0)
OCC = dict(bound=2.0, grid_size=16, update_chunk=1024, density_thresh=1.2)


def _params():
    pj = jnet.init_network(jax.random.PRNGKey(4), jnet.NetworkConfig(**NET))
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")


def _state(cfg_j, partial, seed=0):
    """A JAX occupancy state with a random density grid (a few untrained -1
    cells) and its bitfield, full or partial by the update counter."""
    rng = np.random.default_rng(seed)
    st = jocc.init_occupancy_state(cfg_j)
    grid = rng.exponential(1.0, (cfg_j.cascades, cfg_j.n_cells)).astype(np.float32)
    grid[rng.random(grid.shape) < 0.05] = -1.0
    occ = grid > 1.0
    st = {**st, "density_grid": jnp.asarray(grid),
          "bitfield": jmorton.packbits(jnp.asarray(occ.astype(np.float32))),
          "iter_density": jnp.asarray(cfg_j.n_full_updates if partial else 3, jnp.int32)}
    return st


def _draws(cfg_j, key, partial):
    """The JAX sweep's draws, split from its key as the sweep splits it."""
    out = []
    for _ in range(cfg_j.cascades):
        if partial:
            n = cfg_j.n_cells // 4
            key, k1, k2, k3 = jax.random.split(key, 4)
            out.append(tocc.UpdateDraws(
                rand_cells=torch.as_tensor(np.array(
                    jax.random.randint(k1, (n,), 0, cfg_j.n_cells))).long(),
                u=torch.as_tensor(np.array(jax.random.uniform(k2, (n,)))),
                jitter=torch.as_tensor(np.array(jax.random.uniform(k3, (2 * n, 3))))))
        else:
            key, sub = jax.random.split(key)
            out.append(tocc.UpdateDraws(jitter=torch.as_tensor(np.array(
                jax.random.uniform(sub, (cfg_j.n_cells, 3))))))
    return out


def _assert_states_match(st, sj, cfg):
    """density within 1e-5; bits exact away from the carve bar (returns the
    number of cells within 1e-5 of it)."""
    sj = jax.tree_util.tree_map(np.asarray, sj)
    assert sorted(st) == sorted(sj)
    grid = sj["density_grid"]
    np.testing.assert_allclose(st["density_grid"].numpy(), grid, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(st["mean_density"]), float(sj["mean_density"]),
                               rtol=1e-5)
    assert int(st["iter_density"]) == int(sj["iter_density"])
    np.testing.assert_allclose(st["density_coarse_min"].numpy(), sj["density_coarse_min"],
                               rtol=1e-5, atol=1e-6)
    thresh = min(float(sj["mean_density"]), cfg.density_thresh)
    near = np.abs(grid - thresh) <= 1e-5 * max(thresh, 1.0)
    occ_t = tmorton.unpackbits(st["bitfield"]).numpy().reshape(grid.shape)
    occ_j = np.unpackbits(sj["bitfield"], axis=-1, bitorder="little").astype(bool)
    np.testing.assert_array_equal(occ_t[~near], occ_j[~near])
    if not near.any():
        for k in ("bitfield", "bitfield_coarse", "blocks", "blocks_coarse"):
            np.testing.assert_array_equal(st[k].numpy(), sj[k].astype(st[k].numpy().dtype))
    assert 0.0 < occ_j.mean() < 1.0
    return int(near.sum())


@pytest.mark.parametrize("partial", [False, True])
def test_update_extra_state_matches(partial):
    """A full and a partial sweep with the JAX key's draws (the partial one
    draws occupied cells by inverse CDF over the occupancy mask)."""
    pj, pt = _params()
    cfg_j, cfg_t = jocc.OccupancyConfig(**OCC), tocc.OccupancyConfig(**OCC)
    sj = _state(cfg_j, partial)
    key = jax.random.PRNGKey(9)
    out_j = jocc.update_extra_state(sj, cfg_j, pj, jnet.NetworkConfig(**NET), key)
    st = occupancy_from_numpy(jax.tree_util.tree_map(np.asarray, sj), device="cpu")
    out_t = tocc.update_extra_state(st, cfg_t, pt, tnet.NetworkConfig(**NET),
                                    _draws(cfg_j, key, partial))
    near = _assert_states_match(out_t, out_j, cfg_t)
    assert near <= 2, f"{near} cells within 1e-5 of the carve bar"
    # draw_update gives the draws the sweep needs, from a generator
    draws = tocc.draw_update(torch.Generator().manual_seed(0), st, cfg_t)
    assert len(draws) == cfg_t.cascades and (draws[0].u is not None) == partial


@pytest.mark.parametrize("option", [
    dict(ema_sampled_only=True), dict(occ_hysteresis=0.5),
    dict(density_write_clamp=1.5), dict(ema_toward_query=True),
    dict(density_write_clamp=1.5, ema_toward_query=True), "thresh_cap"])
def test_finish_update_options(option):
    """_finish_update on a given grid and sweep for each option. The
    clamp + toward-query pair is the reference's self-inconsistent
    combination (ROADMAP C): the port copies it, and this test holds only
    that both compute the same thing, not that it is right."""
    kw = dict(OCC, **(option if isinstance(option, dict) else {}))
    cap = 0.7 if option == "thresh_cap" else None
    cfg_j, cfg_t = jocc.OccupancyConfig(**kw), tocc.OccupancyConfig(**kw)
    sj = _state(cfg_j, False, seed=1)
    rng = np.random.default_rng(2)
    tmp = rng.exponential(1.5, sj["density_grid"].shape).astype(np.float32)
    tmp[rng.random(tmp.shape) < 0.5] = -1.0  # unsampled cells
    out_j = jocc._finish_update(sj, cfg_j, sj["density_grid"], jnp.asarray(tmp), None,
                                thresh_cap=None if cap is None else jnp.float32(cap))
    st = occupancy_from_numpy(jax.tree_util.tree_map(np.asarray, sj), device="cpu")
    out_t = tocc._finish_update(st, cfg_t, st["density_grid"], torch.as_tensor(tmp),
                                thresh_cap=cap)
    if cap is not None:
        cfg_t = tocc.OccupancyConfig(**dict(kw, density_thresh=cap))
    assert _assert_states_match(out_t, out_j, cfg_t) == 0


def test_mark_untrained_grid_matches():
    """Cells outside every training frustum are pinned to -1; the rest keep
    their density."""
    cfg_j, cfg_t = jocc.OccupancyConfig(**OCC), tocc.OccupancyConfig(**OCC)
    sj = _state(cfg_j, False, seed=3)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for i, th in enumerate((0.0, 0.7, 2.0)):
        c, s = np.cos(th), np.sin(th)
        poses[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        poses[i, :3, 3] = [-2.5 * s, 0.1, -2.5 * c]
    intr = np.asarray([30.0, 30.0, 16.0, 12.0], np.float32)
    out_j = jocc.mark_untrained_grid(sj, cfg_j, jnp.asarray(poses), jnp.asarray(intr), 24, 32)
    st = occupancy_from_numpy(jax.tree_util.tree_map(np.asarray, sj), device="cpu")
    out_t = tocc.mark_untrained_grid(st, cfg_t, torch.as_tensor(poses),
                                     torch.as_tensor(intr), 24, 32)
    grid_j = np.asarray(out_j["density_grid"])
    assert 0.05 < (grid_j == -1.0).mean() < 0.95
    np.testing.assert_array_equal(out_t["density_grid"].numpy(), grid_j)


def test_reset_and_unported_debounce():
    """reset_extra_state gives a fresh state with the same keys; with
    occ_debounce (unported until the port had it) the state carries a
    cleared "pending" plane through init and reset, and one _finish_update
    from the same grid and sweep gives the reference's bits and pending
    plane (two sweeps: test_occ_debounce_sweeps_match)."""
    cfg = tocc.OccupancyConfig(**OCC)
    st = tocc.init_occupancy_state(cfg, device="cpu")
    st["density_grid"] += 1.0
    fresh = tocc.reset_extra_state(st, cfg)
    assert not bool(fresh["density_grid"].any()) and sorted(fresh) == sorted(st)
    assert "pending" not in st
    cfg_d = tocc.OccupancyConfig(**OCC, occ_debounce=True)
    st_d = tocc.init_occupancy_state(cfg_d, device="cpu")
    assert st_d["pending"].dtype == torch.bool and st_d["pending"].shape == (
        cfg_d.cascades, cfg_d.n_cells) and not bool(st_d["pending"].any())
    st_d["pending"] |= True
    fresh = tocc.reset_extra_state(st_d, cfg_d)
    assert sorted(fresh) == sorted(st_d) and not bool(fresh["pending"].any())
    sj = jocc.init_occupancy_state(jocc.OccupancyConfig(**OCC, occ_debounce=True))
    assert sorted(sj) == sorted(st_d)
    _debounce_sweeps(1)


def _debounce_sweeps(n_sweeps, seed=5):
    """n_sweeps of _finish_update under occ_debounce from one state, each from
    the same random sweep values in both packages (half the cells unsampled,
    the first state's pending plane random); returns the port's states."""
    kw = dict(OCC, occ_debounce=True)
    cfg_j, cfg_t = jocc.OccupancyConfig(**kw), tocc.OccupancyConfig(**kw)
    rng = np.random.default_rng(seed)
    sj = {**_state(cfg_j, False, seed=seed),
          "pending": jnp.asarray(rng.random((cfg_j.cascades, cfg_j.n_cells)) < 0.3)}
    st = occupancy_from_numpy(jax.tree_util.tree_map(np.asarray, sj), device="cpu")
    states = []
    for _ in range(n_sweeps):
        tmp = rng.exponential(1.5, sj["density_grid"].shape).astype(np.float32)
        tmp[rng.random(tmp.shape) < 0.5] = -1.0
        sj = jocc._finish_update(sj, cfg_j, sj["density_grid"], jnp.asarray(tmp), None)
        st = tocc._finish_update(st, cfg_t, st["density_grid"], torch.as_tensor(tmp))
        assert _assert_states_match(st, sj, cfg_t) == 0
        np.testing.assert_array_equal(st["pending"].numpy(), np.asarray(sj["pending"]))
        assert 0 < int(st["pending"].sum()) < st["pending"].numel()
        states.append(st)
    return states


def test_occ_debounce_sweeps_match():
    """Two consecutive debounced sweeps: the bitfield, block tables and
    pending plane equal the reference's after each; the filter held back
    cells a plain sweep would turn on."""
    states = _debounce_sweeps(2, seed=6)
    occ = tmorton.unpackbits(states[-1]["bitfield"]).reshape(states[-1]["density_grid"].shape)
    thresh = min(float(states[-1]["mean_density"]), OCC["density_thresh"])
    assert int((states[-1]["density_grid"] > thresh).sum()) > int(occ.sum())


def test_occ_debounce_update_and_checkpoints(tmp_path):
    """update_extra_state with occ_debounce (a full sweep with the JAX key's
    draws) carries "pending" like the reference; a checkpoint of the state
    written by either package loads into the other with it."""
    from nerfnav_tpu.training import checkpoint as jckpt
    from nerfnav_tpu_torch.training import checkpoint as tckpt

    kw = dict(OCC, occ_debounce=True)
    pj, pt = _params()
    cfg_j, cfg_t = jocc.OccupancyConfig(**kw), tocc.OccupancyConfig(**kw)
    sj = {**_state(cfg_j, False, seed=7),
          "pending": jnp.asarray(np.random.default_rng(7).random(
              (cfg_j.cascades, cfg_j.n_cells)) < 0.3)}
    key = jax.random.PRNGKey(11)
    out_j = jocc.update_extra_state(sj, cfg_j, pj, jnet.NetworkConfig(**NET), key)
    st = occupancy_from_numpy(jax.tree_util.tree_map(np.asarray, sj), device="cpu")
    out_t = tocc.update_extra_state(st, cfg_t, pt, tnet.NetworkConfig(**NET),
                                    _draws(cfg_j, key, False))
    assert _assert_states_match(out_t, out_j, cfg_t) <= 2
    pend = np.asarray(out_j["pending"])
    assert pend.any()
    np.testing.assert_array_equal(out_t["pending"].numpy(), pend)
    tckpt.save_checkpoint(str(tmp_path / "port"), {"occupancy": out_t})
    got_j, _, report = jckpt.load_checkpoint(str(tmp_path / "port"), {"occupancy": out_j})
    assert not report
    jckpt.save_checkpoint(str(tmp_path / "jax"), {"occupancy": out_j})
    got_t, _, report = tckpt.load_checkpoint(
        str(tmp_path / "jax"), {"occupancy": tocc.init_occupancy_state(cfg_t, device="cpu")})
    assert not report
    for k, v in out_t.items():
        np.testing.assert_array_equal(np.asarray(got_j["occupancy"][k]).astype(np.int64),
                                      v.numpy().astype(np.int64), err_msg=k)
        assert got_t["occupancy"][k].dtype == v.dtype
        np.testing.assert_array_equal(got_t["occupancy"][k].numpy().astype(np.int64)
                                      if k.startswith("blocks") else got_t["occupancy"][k].numpy(),
                                      np.asarray(out_j[k]).astype(v.numpy().dtype), err_msg=k)
