"""nerfnav_tpu_torch leaf ops, network and weight bridge vs the JAX package,
on the CPU.

Integer outputs (hash rows, packed bitfields and block rows) must match
exactly and fp32 values within 1e-5. The fused-MLP plain version is held
against the JAX `fused_mlp_reference` within 2e-2, the bound
tests/test_fused_mlp.py uses: hidden activations are re-rounded to bf16, so
a different f32 summation order can move one by a bf16 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfnav_tpu.models import network as jnet
from nerfnav_tpu.models import occupancy as jocc
from nerfnav_tpu.ops import activation as jact
from nerfnav_tpu.ops import fused_mlp as jfm
from nerfnav_tpu.ops import hashgrid as jhg
from nerfnav_tpu.ops import morton as jmorton
from nerfnav_tpu.ops import spherical_harmonics as jsh
from nerfnav_tpu.training import checkpoint as jckpt
from nerfnav_tpu_torch.models import network as tnet
from nerfnav_tpu_torch.models import occupancy as tocc
from nerfnav_tpu_torch.ops import activation as tact
from nerfnav_tpu_torch.ops import fused_mlp as tfm
from nerfnav_tpu_torch.ops import hashgrid as thg
from nerfnav_tpu_torch.ops import morton as tmorton
from nerfnav_tpu_torch.ops import spherical_harmonics as tsh
from nerfnav_tpu_torch.training import checkpoint as tckpt
from nerfnav_tpu_torch.utils import profiling
from test_torch_march import _pack_blocks_np

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


def test_trunc_exp():
    x = np.linspace(-20, 20, 101, dtype=np.float32)
    np.testing.assert_allclose(tact.trunc_exp(torch.as_tensor(x)).numpy(),
                               _np(jact.trunc_exp(jnp.asarray(x))), rtol=1e-6)
    # differentiable, with the reference's clamped derivative
    xt = torch.as_tensor(x).requires_grad_()
    tact.trunc_exp(xt).sum().backward()
    np.testing.assert_allclose(
        xt.grad.numpy(), _np(jax.grad(lambda v: jact.trunc_exp(v).sum())(jnp.asarray(x))),
        rtol=1e-6)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode(degree):
    d = np.random.default_rng(degree).normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(tsh.sh_encode(torch.as_tensor(d), degree).numpy(),
                               _np(jsh.sh_encode(jnp.asarray(d), degree)),
                               rtol=0, atol=1e-5)


GRID_CASES = [
    dict(layout="cell"),
    dict(layout="corner"),
    dict(layout="corner", coord_convention="ngp"),
    dict(layout="cell", gridtype="tiled"),
    dict(layout="corner", gridtype="tiled", coord_convention="ngp"),
    dict(layout="cell", table_compute_dtype="bfloat16"),
    dict(layout="corner", table_compute_dtype="bfloat16"),
]


def _grid_cfgs(case):
    kw = dict(num_levels=4, level_dim=2, base_resolution=4, log2_hashmap_size=10,
              desired_resolution=64, **case)
    return jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)


@pytest.mark.parametrize("case", GRID_CASES, ids=lambda c: "-".join(c.values()))
def test_hash_grid_encode(case):
    cj, ct = _grid_cfgs(case)
    for attr in ("resolutions", "level_sizes", "offsets", "row_dim", "output_dim"):
        assert getattr(cj, attr) == getattr(ct, attr), attr
    rng = np.random.default_rng(0)
    tables = [rng.uniform(-1, 1, (s, cj.row_dim)).astype(np.float32)
              for s in cj.level_sizes]
    x = rng.uniform(-2.2, 2.2, (300, 3)).astype(np.float32)  # some out of bounds
    x[:4] = [[-2, -2, -2], [2, 2, 2], [0, 0, 0], [2, -2, 1.999]]  # edges
    out_j = jhg.hash_grid_encode([jnp.asarray(t) for t in tables], jnp.asarray(x),
                                 cj, bound=2.0)
    out_t = thg.hash_grid_encode([torch.as_tensor(t) for t in tables],
                                 torch.as_tensor(x), ct, bound=2.0)
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", GRID_CASES[:5], ids=lambda c: "-".join(c.values()))
def test_hash_indices_exact(case):
    """Row indices bit for bit, hashed and dense levels, incl. coordinates
    whose prime products overflow 32 bits."""
    cj, ct = _grid_cfgs(case)
    rng = np.random.default_rng(1)
    for level in range(cj.num_levels):
        r = cj.resolutions[level]
        if case["layout"] == "cell":
            c = rng.integers(0, r, (500, 3))
            ij = jhg._cell_indices(cj, level, jnp.asarray(c, jnp.float32))
            it = thg._cell_indices(ct, level, torch.as_tensor(c))
        else:
            c = rng.integers(0, r + 1, (100, 8, 3))
            ij = jhg._corner_indices(cj, level, jnp.asarray(c, jnp.float32))
            it = thg._corner_indices(ct, level, torch.as_tensor(c))
        np.testing.assert_array_equal(it.numpy(), _np(ij).astype(np.int64))


def points_next_to_cell_faces(bound, resolutions, n_per_level=512, seed=0):
    """(N, 3) float32 points within one float32 step of the cell faces of
    each resolution's lattice over [-bound, bound]: on a face, one step
    below and one step above it, on every axis."""
    rng = np.random.default_rng(seed)
    pts = []
    for r in resolutions:
        k = rng.integers(0, r + 1, (n_per_level, 3))
        x = (k / r * 2.0 * bound - bound).astype(np.float32)
        step = rng.integers(-1, 2, (n_per_level, 3))
        x = np.where(step > 0, np.nextafter(x, np.float32(np.inf)),
                     np.where(step < 0, np.nextafter(x, np.float32(-np.inf)), x))
        pts.append(x.astype(np.float32))
    return np.clip(np.concatenate(pts), -bound, bound).astype(np.float32)


@pytest.mark.parametrize("bound", [1.0, 1.5, 3.0])
def test_unit_coords_bits_next_to_cell_faces(bound):
    """The encoder's unit coordinates (x + bound) / (2 bound) equal the
    reference's bit for bit on points next to cell faces, and so does the
    cell each point falls in at every level of the reference-exact grid."""
    cfg = thg.HashGridConfig(desired_resolution=int(2048 * bound))
    x = points_next_to_cell_faces(bound, cfg.resolutions)
    x01_j = np.asarray((jnp.asarray(x) + bound) / (2.0 * bound))
    x01_t = thg.unit_coords(torch.as_tensor(x), bound).numpy()
    np.testing.assert_array_equal(x01_t.view(np.uint32), x01_j.view(np.uint32))
    for r in cfg.resolutions:
        np.testing.assert_array_equal(np.floor(x01_t * np.float32(r)),
                                      np.floor(x01_j * np.float32(r)))


ACTS = ["relu", "none", "exp", "sigmoid", "sine", "squareplus", "softplus"]


@pytest.mark.parametrize("act", ACTS)
def test_fused_mlp_reference_activations(act):
    """The plain version vs the JAX golden, every activation as hidden and
    output activation (within 2e-2, see the module docstring)."""
    rng = np.random.default_rng(ACTS.index(act))
    x = rng.normal(size=(300, 31)).astype(np.float32)
    ws = [rng.normal(scale=0.1, size=s).astype(np.float32)
          for s in ((31, 64), (64, 64), (64, 3))]
    out_j = jfm.fused_mlp_reference(jnp.asarray(x), [jnp.asarray(w) for w in ws], act, act)
    out_t = tfm.fused_mlp(torch.as_tensor(x), [torch.as_tensor(w) for w in ws], act, act)
    assert np.isfinite(_np(out_j)).all()
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n", [1, 1000, 1025])
def test_fused_mlp_ragged_sigma_shape(n):
    """The flagship sigma net 32 -> 64 -> 16 at ragged row counts; the CPU
    path runs the plain version and launches nothing."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    ws = [rng.normal(scale=0.2, size=s).astype(np.float32) for s in ((32, 64), (64, 16))]
    before = tfm.fused_mlp.launches
    out_t = tfm.fused_mlp(torch.as_tensor(x), [torch.as_tensor(w) for w in ws])
    assert tfm.fused_mlp.launches == before
    out_j = jfm.fused_mlp_reference(jnp.asarray(x), [jnp.asarray(w) for w in ws])
    assert out_t.shape == (n, 16) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), rtol=2e-2, atol=2e-2)


# the kernel's contract edges (chip_smoke.py checks the card's kernel at the
# same shapes against the plain version): name -> (dims, rows)
MLP_EDGES = {
    "8x128": ([128] * 9, 257),
    "3-256-256-1": ([3, 256, 256, 1], 257),
    "1-16-1": ([1, 16, 1], 257),
    **{f"color-N{n}": ([31, 64, 64, 3], n) for n in (1, 127, 128, 129, 8192, 32768)},
}


@pytest.mark.parametrize("edge", [*MLP_EDGES, "color-misaligned"])
def test_fused_mlp_contract_edges(edge):
    """The plain version vs the JAX golden at the contract's edges, and on an
    x that starts one row (124 bytes) into its buffer (within 2e-2)."""
    dims, n = MLP_EDGES.get(edge, ([31, 64, 64, 3], 1000))
    rng = np.random.default_rng(list(MLP_EDGES).index(edge) if edge in MLP_EDGES else 99)
    buf = torch.as_tensor(rng.normal(size=(n + 1, dims[0])).astype(np.float32))
    x = buf[1:] if edge == "color-misaligned" else buf[:n]
    ws = [rng.uniform(-1, 1, size=(a, b)).astype(np.float32) / np.sqrt(a)
          for a, b in zip(dims[:-1], dims[1:])]
    out_t = tfm.fused_mlp(x, [torch.as_tensor(w) for w in ws])
    out_j = jfm.fused_mlp_reference(jnp.asarray(x.numpy()), [jnp.asarray(w) for w in ws])
    assert out_t.shape == (n, dims[-1]) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), rtol=2e-2, atol=2e-2)


def test_fused_mlp_rejects_what_the_kernel_cannot_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="layers"):
        tfm.fused_mlp(x, [torch.zeros(8, 8)] * 9)
    with pytest.raises(ValueError, match="widths"):
        tfm.fused_mlp(x, [torch.zeros(8, 300), torch.zeros(300, 4)])
    with pytest.raises(ValueError, match="does not follow"):
        tfm.fused_mlp(x, [torch.zeros(8, 16), torch.zeros(8, 4)])
    # an input that requires grad now takes the reference's backward
    w = torch.full((8, 4), 0.5, requires_grad=True)
    xg = torch.ones(4, 8, requires_grad=True)
    tfm.fused_mlp(xg, [w]).sum().backward()
    _, vjp = jax.vjp(jfm.fused_mlp_reference, jnp.ones((4, 8)), [jnp.full((8, 4), 0.5)])
    dxj, (dwj,) = vjp(jnp.ones((4, 4)))
    np.testing.assert_array_equal(xg.grad.numpy(), _np(dxj))
    np.testing.assert_array_equal(w.grad.numpy(), _np(dwj))


# the backward kernel's route: the nets the port builds take the kernel on a
# CUDA tensor; wider nets and other hidden activations the plain backward
BWD_NETS = {"sigma": ([32, 64, 16], "relu", True), "color": ([31, 64, 64, 3], "relu", True),
            "bg": ([24, 64, 3], "relu", True), "8x128": ([128] * 9, "relu", False),
            "3-256-256-1": ([3, 256, 256, 1], "relu", False),
            "color-sigmoid": ([31, 64, 64, 3], "sigmoid", False)}


def _counted_backward(x, ws, g, dims, act):
    before = profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("test.mlp_backward"):
            dx, dws = tfm._backward(x, ws, None, g, dims, act, "none")
    assert dx.shape == x.shape and [d.shape for d in dws] == [w.shape for w in ws]
    got = profiling.counters_since(before).get("test.mlp_backward", {})
    return got.get("fused_mlp_bwd_kernel_calls", 0), got.get("fused_mlp_bwd_plain_calls", 0)


@pytest.mark.parametrize("net", BWD_NETS)
def test_fused_mlp_backward_route(net, monkeypatch):
    """With the C launcher stubbed, a tensor off the CPU (on the meta
    device, standing in for a CUDA one) takes the kernel for the sigma,
    color and bg nets and the plain backward for a net wider than 64 or a
    sigmoid hidden activation; a CPU tensor always takes the plain backward.
    Each backward counts its route while tracing."""
    dims, act, kernel = BWD_NETS[net]
    assert tfm.backward_takes_kernel(dims, act) == kernel
    launched = []

    def launcher(x, wb, g, dims_, act_, out_act):
        launched.append(list(dims_))
        return torch.zeros_like(x), [torch.zeros(a, b, device=x.device)
                                     for a, b in zip(dims_[:-1], dims_[1:])]

    monkeypatch.setattr(tfm, "_launch_backward", launcher)
    for device, counts in (("meta", (int(kernel), int(not kernel))), ("cpu", (0, 1))):
        ws = [torch.zeros(a, b, device=device) for a, b in zip(dims[:-1], dims[1:])]
        x, g = torch.zeros(8, dims[0], device=device), torch.zeros(8, dims[-1], device=device)
        assert _counted_backward(x, ws, g, dims, act) == counts, device
    assert launched == ([dims] if kernel else [])


@pytest.mark.parametrize("net", ["sigma", "color", "bg"])
def test_fused_mlp_backward_cpu_bits(net):
    """On the CPU the backward is the plain recompute, bit for bit: the
    same as `_mlp_backward` and, at 64 rows (where torch's and XLA's f32
    sums take one order), as jax.vjp(fused_mlp_reference); zero rows take
    relu's half gradient; nothing launches."""
    dims, _, _ = BWD_NETS[net]
    rng = np.random.default_rng(len(dims) * 10 + dims[0])
    x = rng.normal(size=(64, dims[0])).astype(np.float32)
    x[::7] = 0.0  # exact-zero pre-activations
    ws = [(rng.uniform(-1, 1, size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    g = rng.normal(size=(64, dims[-1])).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_()
    wt = [torch.as_tensor(w).requires_grad_() for w in ws]
    before = tfm.fused_mlp.bwd_launches
    (tfm.fused_mlp(xt, wt) * torch.as_tensor(g)).sum().backward()
    assert tfm.fused_mlp.bwd_launches == before
    dx, dws = tfm._mlp_backward(torch.as_tensor(x), [torch.as_tensor(w) for w in ws],
                                torch.as_tensor(g), "relu", "none")
    _, vjp = jax.vjp(jfm.fused_mlp_reference, jnp.asarray(x), [jnp.asarray(w) for w in ws])
    dxj, dwj = vjp(jnp.asarray(g))
    for got, plain, want in zip([xt.grad, *[w.grad for w in wt]], [dx, *dws], [dxj, *dwj]):
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_morton_packing_exact():
    rng = np.random.default_rng(4)
    occ = rng.random((2, 16**3)) < 0.2
    np.testing.assert_array_equal(
        tmorton.packbits(torch.as_tensor(occ)).numpy(),
        _np(jmorton.packbits(jnp.asarray(occ.astype(np.float32)))))
    bits = tmorton.packbits(torch.as_tensor(occ))
    np.testing.assert_array_equal(np.packbits(occ, axis=-1, bitorder="little"),
                                  bits.numpy())
    np.testing.assert_array_equal(tmorton.unpackbits(bits).numpy(), occ)
    for block in (4, 8):
        rows_j = _np(jmorton.pack_blocks(jnp.asarray(occ), 16, block=block))
        rows_t = tmorton.pack_blocks(torch.as_tensor(occ), 16, block=block)
        np.testing.assert_array_equal(rows_t.numpy(), rows_j.astype(np.int64))
        np.testing.assert_array_equal(_pack_blocks_np(occ, 16, block), rows_j)
        assert tmorton.block_size_of(rows_t) == block
        np.testing.assert_array_equal(tmorton.unpack_blocks(rows_t, 16).numpy(), occ)
        local = rng.integers(0, block**3, (2, rows_j.shape[1]))
        np.testing.assert_array_equal(
            tmorton.block_bit_lookup(rows_t, torch.as_tensor(local)).numpy(),
            _np(jmorton.block_bit_lookup(jnp.asarray(rows_j), jnp.asarray(local))))


def _net_kw(**kw):
    base = dict(bound=1.0, grid_levels=3, grid_level_dim=4, grid_log2_hashmap_size=10,
                grid_max_resolution=48, grid_layout="cell")
    base.update(kw)
    return base


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_network_matches(backend):
    """density + color through the bridge-loaded params: the xla fp32 field
    within 1e-5; the fused field (JAX: the Pallas kernel in interpret mode)
    within 2e-2."""
    kw = _net_kw(mlp_backend=backend)
    pj = jnet.init_network(jax.random.PRNGKey(1), jnet.NetworkConfig(**kw))
    pt = tckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    cj, ct = jnet.NetworkConfig(**kw), tnet.NetworkConfig(**kw)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sj, rj = jnet.forward(pj, jnp.asarray(x), jnp.asarray(d), cj)
    st, rt = tnet.forward(pt, torch.as_tensor(x), torch.as_tensor(d), ct)
    tol = 1e-5 if backend == "xla" else 2e-2
    np.testing.assert_allclose(st.numpy(), _np(sj), rtol=tol, atol=tol)
    np.testing.assert_allclose(rt.numpy(), _np(rj), rtol=0, atol=tol)


def test_checkpoint_bridge(tmp_path):
    """A JAX-package checkpoint (path-keyed npz) loads into the port: the
    same params and occupancy, uint32 block words as int64."""
    kw = _net_kw()
    pj = jnet.init_network(jax.random.PRNGKey(2), jnet.NetworkConfig(**kw))
    occ = {"bitfield": jnp.asarray(np.arange(64, dtype=np.uint8).reshape(1, 64)),
           "blocks": jnp.asarray(np.array([[[0, 2**32 - 1]]], np.uint32)),
           "density_grid": jnp.ones((1, 8), jnp.float32)}
    path = str(tmp_path / "ngp_ep0001")
    jckpt.save_checkpoint(path, {"params": pj, "ema_params": pj, "occupancy": occ},
                          {"epoch": 1})
    out = tckpt.load_checkpoint_npz(path, device="cpu")
    assert out["meta"] == {"epoch": 1}
    for k in ("encoder", "sigma_net", "color_net"):
        assert len(out["ema_params"][k]) == len(pj[k])
        for a, b in zip(out["ema_params"][k], pj[k]):
            np.testing.assert_array_equal(a.numpy(), _np(b))
    assert out["occupancy"]["blocks"].dtype == torch.int64
    assert out["occupancy"]["blocks"].tolist() == [[[0, 2**32 - 1]]]
    np.testing.assert_array_equal(out["occupancy"]["bitfield"].numpy(),
                                  _np(occ["bitfield"]))
    # a model-only ("best") checkpoint keeps its params at the root
    jckpt.save_checkpoint(str(tmp_path / "ngp_best"), pj, {})
    best = tckpt.load_checkpoint_npz(str(tmp_path / "ngp_best.npz"), device="cpu")
    assert best["occupancy"] is None
    np.testing.assert_array_equal(best["ema_params"]["sigma_net"][0].numpy(),
                                  _np(pj["sigma_net"][0]))


@pytest.mark.parametrize("bound,grid", [(1.0, 16), (2.0, 32), (4.0, 20)])
def test_occupancy_state_layout(bound, grid):
    """The empty occupancy state has the reference's keys and shapes (block
    tables only where the grid admits them; uint32 words as int64)."""
    kw = dict(bound=bound, grid_size=grid)
    sj = jocc.init_occupancy_state(jocc.OccupancyConfig(**kw))
    st = tocc.init_occupancy_state(tocc.OccupancyConfig(**kw), device="cpu")
    assert sorted(st) == sorted(sj)
    for k, v in sj.items():
        assert tuple(st[k].shape) == v.shape, k
        assert not bool(st[k].any()), k
    if "blocks" in st:
        assert st["blocks"].dtype == torch.int64
