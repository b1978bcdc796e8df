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
    cfg = tocc.OccupancyConfig(**OCC)
    st = tocc.init_occupancy_state(cfg, device="cpu")
    st["density_grid"] += 1.0
    fresh = tocc.reset_extra_state(st, cfg)
    assert not bool(fresh["density_grid"].any()) and sorted(fresh) == sorted(st)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tocc._finish_update(st, tocc.OccupancyConfig(**OCC, occ_debounce=True),
                            st["density_grid"], st["density_grid"])
