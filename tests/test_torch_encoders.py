"""nerfnav_tpu_torch's frequency encoder, encoder factory, losses and Morton
codes vs the JAX package's, on the CPU.

Inputs come from numpy seeds. fp32 values and gradients agree within 1e-5;
integer codes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfnav_tpu.models.encoding import get_encoder as j_get_encoder
from nerfnav_tpu.ops import frequency as jfreq
from nerfnav_tpu.ops import losses as jloss
from nerfnav_tpu.ops import morton as jmorton
from nerfnav_tpu_torch.models.encoding import get_encoder as t_get_encoder
from nerfnav_tpu_torch.ops import frequency as tfreq
from nerfnav_tpu_torch.ops import losses as tloss
from nerfnav_tpu_torch.ops import morton as tmorton

torch.set_num_threads(1)

TOL = 1e-5


def _grad_t(fn, *args):
    """Value and gradients of torch fn w.r.t. every argument."""
    ts = [torch.as_tensor(a).requires_grad_() for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, allow_unused=True)
    return out.detach().numpy(), [None if g is None else g.numpy() for g in grads]


@pytest.mark.parametrize("degree", [0, 4, 10])
def test_freq_encode_values_and_grads(degree):
    rng = np.random.default_rng(degree)
    x = rng.uniform(-1.5, 1.5, (37, 3)).astype(np.float32)
    assert tfreq.freq_output_dim(3, degree) == jfreq.freq_output_dim(3, degree)
    yj = np.asarray(jfreq.freq_encode(jnp.asarray(x), degree))
    yt = tfreq.freq_encode(torch.as_tensor(x), degree)
    assert yt.shape == (37, tfreq.freq_output_dim(3, degree))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=TOL)
    w = rng.normal(size=yj.shape).astype(np.float32)
    gj = np.asarray(jax.grad(lambda a: jnp.sum(jfreq.freq_encode(a, degree) * w))(
        jnp.asarray(x)))
    _, (gt,) = _grad_t(lambda a: (tfreq.freq_encode(a, degree) * torch.as_tensor(w)).sum(), x)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=TOL * max(1.0, np.abs(gj).max()))


ENCODERS = {
    "None": (None, {}), "none": ("none", {}),
    "frequency": ("frequency", {"multires": 5}),
    "sphere_harmonics": ("sphere_harmonics", {"degree": 4}),
    "spherical_harmonics": ("spherical_harmonics", {"degree": 3}),
    "hashgrid": ("hashgrid", {"num_levels": 4, "level_dim": 2, "base_resolution": 4,
                              "log2_hashmap_size": 8, "desired_resolution": 32}),
    "tiledgrid": ("tiledgrid", {"num_levels": 3, "level_dim": 2, "base_resolution": 8,
                                "log2_hashmap_size": 9, "desired_resolution": 64,
                                "bound": 2.0}),
    "hashgrid_2d_cell": ("hashgrid", {"input_dim": 2, "num_levels": 3, "level_dim": 2,
                                      "log2_hashmap_size": 10, "desired_resolution": 128,
                                      "layout": "cell"}),
}


@pytest.mark.parametrize("name", list(ENCODERS))
def test_get_encoder_matches(name):
    """Every name: the same output_dim, no init_fn where JAX has none, and
    the same features from the same tables (the grids' JAX tables carried
    across); the port's init_fn draws tables of the JAX shapes."""
    enc, kw = ENCODERS[name]
    init_j, fn_j, dim_j = j_get_encoder(enc, **kw)
    init_t, fn_t, dim_t = t_get_encoder(enc, **kw)
    assert dim_t == dim_j and (init_t is None) == (init_j is None)
    d_in = kw.get("input_dim", 3)
    bound = kw.get("bound", 1.0)
    rng = np.random.default_rng(1)
    x = rng.uniform(-bound, bound, (41, d_in)).astype(np.float32)
    if enc in ("sphere_harmonics", "spherical_harmonics"):
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    pj = pt = None
    if init_j is not None:
        pj = init_j(jax.random.PRNGKey(3))
        # scale the tables up so the features are not all near zero
        pj = [a * 1e3 for a in pj]
        pt = [torch.as_tensor(np.array(a)) for a in pj]
        drawn = init_t(torch.Generator().manual_seed(0), device="cpu")
        assert [tuple(t.shape) for t in drawn] == [tuple(a.shape) for a in pj]
        assert all(float(t.abs().max()) <= 1e-4 for t in drawn)
    yj = np.asarray(fn_j(pj, jnp.asarray(x)))
    yt = fn_t(pt, torch.as_tensor(x)).numpy()
    assert yt.shape == yj.shape == (41, dim_t)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=TOL * max(1.0, np.abs(yj).max()))


def test_get_encoder_unknown_raises():
    with pytest.raises(ValueError, match="unknown encoding"):
        t_get_encoder("nonsense")
    with pytest.raises(ValueError, match="unknown encoding"):
        j_get_encoder("nonsense")


def _loss_cases():
    rng = np.random.default_rng(7)
    pred = rng.uniform(-1, 1, (8, 33)).astype(np.float32)
    target = rng.uniform(-1, 1, (8, 33)).astype(np.float32)
    target[0, :4] = 0.0  # the 1e-2 guard of the MAPE denominator
    pred[1, :3] = target[1, :3] + np.float32(0.1)  # near the Huber knee
    w = rng.uniform(0, 1, (8, 33)).astype(np.float32)
    t = np.cumsum(rng.uniform(0.001, 0.05, (8, 33)), axis=-1).astype(np.float32)
    interval = rng.uniform(0.001, 0.05, (8, 33)).astype(np.float32)
    return pred, target, w, t, interval


@pytest.mark.parametrize("loss", ["mape", "mape_none", "huber", "huber_none", "distloss",
                                  "distloss_scalar_interval"])
def test_losses_values_and_grads(loss):
    pred, target, w, t, interval = _loss_cases()
    rw = np.random.default_rng(8).normal(size=pred.shape).astype(np.float32)
    if loss.startswith("mape") or loss.startswith("huber"):
        red = "none" if loss.endswith("none") else "mean"
        name = loss.split("_")[0] + "_loss"
        fj, ft = getattr(jloss, name), getattr(tloss, name)

        def jfn(p, q):
            out = fj(p, q, reduction=red)
            return jnp.sum(out * rw) if red == "none" else out

        def tfn(p, q):
            out = ft(p, q, reduction=red)
            return (out * torch.as_tensor(rw)).sum() if red == "none" else out

        args = (pred, target)
    else:
        scalar = loss.endswith("interval")
        iv = np.float32(0.02) if scalar else interval

        def jfn(a, b):
            return jloss.eff_distloss(a, b, iv)

        def tfn(a, b):
            return tloss.eff_distloss(a, b, float(iv) if scalar else torch.as_tensor(iv))

        args = (w, t)
    vj, gj = jax.value_and_grad(jfn, argnums=(0, 1))(*map(jnp.asarray, args))
    vt, gt = _grad_t(tfn, *args)
    np.testing.assert_allclose(vt, np.asarray(vj), rtol=TOL, atol=TOL)
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        if a is None:  # detached or unused argument: zero in JAX
            assert not b.any()
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * max(1.0, np.abs(b).max()))


def test_morton_codes_exact():
    """morton3d on coords over [0, 1024), including the corners, and
    morton3d_invert on random uint32 codes (bit 31 set too), exactly."""
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 1024, (5000, 3)).astype(np.int64)
    coords[:3] = [[0, 0, 0], [1023, 1023, 1023], [1023, 0, 512]]
    cj = np.asarray(jmorton.morton3d(jnp.asarray(coords, jnp.uint32))).astype(np.int64)
    ct = tmorton.morton3d(torch.as_tensor(coords))
    assert ct.dtype == torch.int64
    np.testing.assert_array_equal(ct.numpy(), cj)
    codes = rng.integers(0, 2**32, 5000, dtype=np.uint64)
    codes[:2] = [0, 2**32 - 1]
    ij = np.asarray(jmorton.morton3d_invert(jnp.asarray(codes.astype(np.uint32))))
    it = tmorton.morton3d_invert(torch.as_tensor(codes.astype(np.int64)))
    np.testing.assert_array_equal(it.numpy(), ij.astype(np.int64))
    np.testing.assert_array_equal(tmorton.morton3d_invert(ct).numpy(), coords)


@pytest.mark.parametrize("grid_size", [8, 32])
def test_rowmajor_to_morton_exact(grid_size):
    pj = jmorton.rowmajor_to_morton(grid_size)
    pt = tmorton.rowmajor_to_morton(grid_size)
    assert isinstance(pt, np.ndarray) and pt.dtype == np.int64
    np.testing.assert_array_equal(pt, pj)
    assert sorted(pt.tolist()) == list(range(grid_size**3))
