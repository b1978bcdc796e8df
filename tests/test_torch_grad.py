"""Gradients of the nerfnav_tpu_torch leaf ops vs the JAX package's, on the
CPU: trunc_exp (backward and jvp), the fused MLP's backward and the hash-grid
encode (tables and x).

The same inputs, made with numpy from a seed, go through `jax.vjp` /
`jax.jvp` of the JAX function and torch autograd of its port. fp32 gradients
agree within 1e-5 (relative to the largest entry). The fused MLP's backward
rounds every dh and dW to bf16 at the reference's points; its gradients
agree exactly up to f32 summation order. Where another order moves one
rounding, the next layer's products carry that bf16 step on, so for nets of
up to 3 layers (the flagship's) the test allows one bf16 step (2^-8) of the
value plus one of the largest entry. Through deeper nets the moved roundings
compound, in the forward recompute too: there each gradient must agree
within L bf16 steps (L 2^-8) in relative L2 norm for an L-layer net (the
8-layer edge measures 0.76%, about 2 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfnav_tpu.ops import activation as jact
from nerfnav_tpu.ops import fused_mlp as jfm
from nerfnav_tpu.ops import hashgrid as jhg
from nerfnav_tpu_torch.ops import activation as tact
from nerfnav_tpu_torch.ops import fused_mlp as tfm
from nerfnav_tpu_torch.ops import hashgrid as thg
from test_torch_ops import ACTS, GRID_CASES, MLP_EDGES

torch.set_num_threads(1)

BF16_STEP = 2.0**-8


def test_trunc_exp_grad_and_jvp():
    """Backward and forward mode within 1e-6 (relative) over [-20, 20],
    across the +-15 clamp of the derivative."""
    x = np.linspace(-20, 20, 201, dtype=np.float32)
    t = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    gj = jax.grad(lambda v: jnp.sum(jact.trunc_exp(v) * t))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    (tact.trunc_exp(xt) * torch.as_tensor(t)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-6, atol=0)
    pj, tj = jax.jvp(jact.trunc_exp, (jnp.asarray(x),), (jnp.asarray(t),))
    pt, tt = torch.func.jvp(tact.trunc_exp, (torch.as_tensor(x),), (torch.as_tensor(t),))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6, atol=0)
    assert float(xt.grad[0]) == pytest.approx(float(t[0]) * np.exp(-15.0), rel=1e-6)


def _mlp_grads(x, ws, g, act="relu", out_act="none"):
    """(dx, [dW]) from jax.vjp of the JAX golden and from the port's
    autograd on the CPU, as numpy."""
    _, vjp = jax.vjp(lambda a, b: jfm.fused_mlp_reference(a, b, act, out_act),
                     jnp.asarray(x), [jnp.asarray(w) for w in ws])
    dxj, dwj = vjp(jnp.asarray(g))
    xt = torch.as_tensor(x).requires_grad_()
    wt = [torch.as_tensor(w).requires_grad_() for w in ws]
    before = tfm.fused_mlp.launches
    out = tfm.fused_mlp(xt, wt, act, out_act)
    (out * torch.as_tensor(g)).sum().backward()
    assert tfm.fused_mlp.launches == before  # the CPU runs the plain version
    return ([xt.grad.numpy()] + [w.grad.numpy() for w in wt],
            [np.asarray(dxj)] + [np.asarray(d) for d in dwj])


def _assert_bf16_close(got, want):
    layers = len(got) - 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == np.float32
        if layers <= 3:
            np.testing.assert_allclose(a, b, rtol=BF16_STEP,
                                       atol=BF16_STEP * np.abs(b).max())
        else:
            assert np.linalg.norm(a - b) <= layers * BF16_STEP * np.linalg.norm(b)


@pytest.mark.parametrize("edge", ["sigma-N4096", "color-N4096", *MLP_EDGES])
def test_fused_mlp_backward(edge):
    """dx and every dW against jax.vjp(fused_mlp_reference) for the flagship
    sigma and color nets and the kernel's contract edges."""
    dims, n = {"sigma-N4096": ([32, 64, 16], 4096),
               "color-N4096": ([31, 64, 64, 3], 4096)}.get(edge) or MLP_EDGES[edge]
    rng = np.random.default_rng(len(edge) * 7 + n)
    x = rng.normal(size=(n, dims[0])).astype(np.float32)
    ws = [(rng.uniform(-1, 1, size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    g = rng.normal(size=(n, dims[-1])).astype(np.float32)
    got, want = _mlp_grads(x, ws, g)
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("act", ACTS)
def test_fused_mlp_backward_activations(act):
    """Every activation as hidden and output activation; the relu case has
    exact zeros in its pre-activations, where the reference's jnp.maximum
    passes half the gradient."""
    rng = np.random.default_rng(ACTS.index(act) + 40)
    x = rng.normal(size=(300, 31)).astype(np.float32)
    x[:20] = 0.0  # zero rows: zero pre-activations in every layer
    ws = [rng.normal(scale=0.1, size=s).astype(np.float32)
          for s in ((31, 64), (64, 64), (64, 3))]
    g = rng.normal(size=(300, 3)).astype(np.float32)
    got, want = _mlp_grads(x, ws, g, act, act)
    _assert_bf16_close(got, want)


def _grid_grads(case, backward, seed=0):
    kw = dict(num_levels=4, level_dim=2, base_resolution=4, log2_hashmap_size=10,
              desired_resolution=64, backward=backward, **case)
    cj, ct = jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)
    rng = np.random.default_rng(seed)
    tables = [rng.uniform(-1, 1, (s, cj.row_dim)).astype(np.float32)
              for s in cj.level_sizes]
    x = rng.uniform(-2.2, 2.2, (300, 3)).astype(np.float32)  # some out of bounds
    x[:4] = [[-2, -2, -2], [2, 2, 2], [0, 0, 0], [2, -2, 1.999]]  # edges
    g = rng.normal(size=(300, cj.output_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda t, p: jhg.hash_grid_encode(t, p, cj, bound=2.0),
                     [jnp.asarray(t) for t in tables], jnp.asarray(x))
    dtj, dxj = vjp(jnp.asarray(g))
    tt = [torch.as_tensor(t).requires_grad_() for t in tables]
    xt = torch.as_tensor(x).requires_grad_()
    out = thg.hash_grid_encode(tt, xt, ct, bound=2.0)
    (out * torch.as_tensor(g)).sum().backward()
    return ([t.grad.numpy() for t in tt], xt.grad.numpy(),
            [np.asarray(d) for d in dtj], np.asarray(dxj))


@pytest.mark.parametrize("backward", ["xla", "sort"])
@pytest.mark.parametrize("case", GRID_CASES, ids=lambda c: "-".join(c.values()))
def test_hash_grid_encode_grads(case, backward):
    """Table and x gradients against jax.vjp for both layouts, both
    conventions, tiled grids and both backward strategies (the port sums
    "sort" as "xla" does). f32 tables: 1e-5 of the largest entry. bf16 table
    compute accumulates each table's gradient in bf16 in both frameworks, in
    another order: within 2 bf16 steps (2^-7) of the largest entry."""
    dtt, dxt, dtj, dxj = _grid_grads(case, backward)
    bf16 = case.get("table_compute_dtype") == "bfloat16"
    for a, b in zip(dtt, dtj):
        assert a.dtype == np.float32 and a.shape == b.shape
        tol = (2 * BF16_STEP if bf16 else 1e-5) * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    np.testing.assert_allclose(dxt, dxj, rtol=0, atol=1e-5 * np.abs(dxj).max())
    assert np.abs(dxj).max() > 0 and np.abs(dxt[0]).max() > 0  # the edges
