"""The hash-grid kernel path of nerfnav_tpu_torch/ops/hashgrid.py.

On the CPU (tier 1): training configs pick the kernel and nav's the plain
version; a CPU tensor under backend "fused" runs the plain version bit for
bit and launches nothing; the wrapper raises on what the kernel does not
take; the plain calls are counted while tracing.

Marked `card` (each skips without a CUDA card): the kernels of
csrc/hashgrid.cu against the plain version on the card, over the layouts,
grid types, conventions, input dims, feature widths and table types, with
points on cell faces, on the bound and outside it, and N = 0, 1 and ragged.
The forward must equal the CPU's plain version bit for bit: the kernel
takes the CPU's order of products and sums, where the order of the sum over
corners is that of torch's vectorised CPU reduction as read on torch 2.13
and 2.11 with the AVX-512 dispatch; where this host's torch sums in another order,
the bit-for-bit checks skip and say so. Tolerances against the plain
version on the card, relative to the largest entry of the compared tensor:
- forward 1e-6: torch's CUDA product of the weights takes another order
  than the CPU's (a few float32 ulps of a sum whose weights add up to 1);
- table gradient 1e-5: each row sums its contributions in the order the
  atomic adds land, the plain version in its index_add_'s;
- dy/dx 1e-5: the kernel takes the product of the other weights where
  autograd divides the product by one of them, and sums in another order.
The deterministic route (torch's deterministic mode, or backward "sort")
must repeat bit for bit. This file imports no JAX, so on the card's
machine it runs with `python -m pytest --noconftest
tests/test_torch_hashgrid_kernel.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerfnav_tpu_torch.cli import flags
from nerfnav_tpu_torch.ops import hashgrid as hg
from nerfnav_tpu_torch.utils import profiling

BOUND = 2.0

# (name, HashGridConfig keywords): both layouts, hash and tiled grids, both
# conventions, D 2 and 3, F 1, 2, 4 and 8, f32 and bf16 table compute
CASES = [
    ("corner", {}),
    ("cell", dict(layout="cell")),
    ("corner-ngp", dict(coord_convention="ngp")),
    ("cell-tiled", dict(layout="cell", gridtype="tiled")),
    ("corner-tiled-ngp", dict(gridtype="tiled", coord_convention="ngp")),
    ("corner-bf16", dict(table_compute_dtype="bfloat16")),
    ("cell-bf16", dict(layout="cell", table_compute_dtype="bfloat16")),
    ("corner-2d", dict(input_dim=2)),
    ("cell-2d-ngp", dict(input_dim=2, layout="cell", coord_convention="ngp")),
    ("corner-f1", dict(level_dim=1)),
    ("corner-f4-ngp", dict(level_dim=4, coord_convention="ngp")),
    ("cell-f8", dict(layout="cell", level_dim=8)),
    ("corner-f8-2d", dict(level_dim=8, input_dim=2)),
]
F32_CASES = [c for c in CASES if "bf16" not in c[0]]


def _config(kw, **extra):
    base = dict(num_levels=4, level_dim=2, base_resolution=4, log2_hashmap_size=10,
                desired_resolution=64, backend="fused")
    return hg.HashGridConfig(**{**base, **kw, **extra})


def _tables(cfg, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.uniform(-1, 1, (s, cfg.row_dim)).astype(np.float32),
                            device=device) for s in cfg.level_sizes]


def _points(cfg, n, seed=0, device="cpu"):
    """n points: some out of bounds, the corners of the bound, the centre,
    and points on the cell faces of every level and one float32 step on
    either side of them."""
    rng = np.random.default_rng(seed + 1)
    d = cfg.input_dim
    x = rng.uniform(-1.1 * BOUND, 1.1 * BOUND, (n, d)).astype(np.float32)
    faces = []
    for r in cfg.resolutions:
        k = rng.integers(0, r + 1, (8, d))
        f = (k / r * 2.0 * BOUND - BOUND).astype(np.float32)
        step = rng.integers(-1, 2, (8, d))
        faces.append(np.where(step > 0, np.nextafter(f, np.float32(np.inf)),
                              np.where(step < 0, np.nextafter(f, np.float32(-np.inf)), f)))
    edges = np.concatenate([np.full((1, d), -BOUND, np.float32),
                            np.full((1, d), BOUND, np.float32),
                            np.zeros((1, d), np.float32), *faces])
    m = min(n, len(edges))
    x[:m] = edges[:m]
    return torch.as_tensor(x, device=device)


def _parse(argv):
    return flags.build_parser("t").parse_args(["scene", *argv])


@pytest.mark.parametrize("for_nav", [False, True])
@pytest.mark.parametrize("argv", [[], ["-O"], ["--cuda_ray", "--ff", "--bg_radius", "8"]])
def test_make_configs_picks_the_kernel_for_training(argv, for_nav):
    cfg = flags.make_configs(_parse(argv), for_nav=for_nav)[0]
    want = "xla" if for_nav else "fused"
    assert cfg.grid_backend == want
    assert cfg.grid.backend == cfg.bg_grid.backend == want


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_fused_on_the_cpu_is_the_plain_version(name, kw):
    cfg = _config(kw)
    plain = dataclasses.replace(cfg, backend="xla")
    launches = hg.hash_grid_encode.launches
    train = "bf16" not in name  # the kernel path trains no bf16 table
    outs = []
    for c in (cfg, plain):
        tabs = [t.requires_grad_(train) for t in _tables(c)]
        x = _points(c, 300).requires_grad_(train)
        out = hg.hash_grid_encode(tabs, x, c, bound=BOUND)
        grads = []
        if train:
            g = torch.as_tensor(np.random.default_rng(2).normal(size=out.shape)
                                .astype(np.float32))
            (out * g).sum().backward()
            grads = [x.grad] + [t.grad for t in tabs]
        outs.append((out.detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert outs[0][0].abs().max() > 0
    assert hg.hash_grid_encode.launches == launches


BAD_CONFIGS = [
    ("input_dim 4", dict(input_dim=4)),
    ("level_dim 3", dict(level_dim=3)),
    ("33 levels", dict(num_levels=33)),
    ("gridtype", dict(gridtype="dense")),
    ("layout", dict(layout="vertex")),
]


@pytest.mark.parametrize("name,kw", BAD_CONFIGS, ids=[c[0] for c in BAD_CONFIGS])
def test_the_kernel_path_raises_on_configs_it_does_not_take(name, kw):
    cfg = _config(kw)
    with pytest.raises(ValueError):
        hg.hash_grid_encode(_tables(dataclasses.replace(cfg, backend="xla")),
                            torch.zeros((4, cfg.input_dim)), cfg, bound=BOUND)


def _bad_args():
    cfg = _config({})
    tabs = _tables(cfg)
    x = torch.zeros((4, 3))
    return {
        "x not (N, D)": (tabs, torch.zeros((4, 2))),
        "x 3-d": (tabs, torch.zeros((4, 1, 3))),
        "a table short": (tabs[:-1], x),
        "a table's shape": (tabs[:-1] + [tabs[-1][:-8]], x),
        "float16 tables": ([t.half() for t in tabs], x),
        "mixed dtypes": ([tabs[0].bfloat16()] + tabs[1:], x),
        "a bf16 table to train": ([t.bfloat16().requires_grad_() for t in tabs], x),
        "bf16 compute to train": ("bf16", x),
    }


@pytest.mark.parametrize("what", list(_bad_args()))
def test_the_kernel_path_raises_on_arguments_it_does_not_take(what):
    tabs, x = _bad_args()[what]
    cfg = _config({})
    if tabs == "bf16":
        cfg = _config({}, table_compute_dtype="bfloat16")
        tabs = [t.requires_grad_() for t in _tables(cfg)]
    with pytest.raises(ValueError):
        hg.hash_grid_encode(tabs, x, cfg, bound=BOUND)
    with pytest.raises(ValueError):
        hg.hash_grid_encode(tabs, x, dataclasses.replace(cfg, backend="tpu"), bound=BOUND)


def test_bf16_tables_under_no_grad_are_taken():
    cfg = _config({})
    tabs = [t.bfloat16().requires_grad_() for t in _tables(cfg)]
    with torch.no_grad():
        out = hg.hash_grid_encode(tabs, _points(cfg, 64), cfg, bound=BOUND)
    assert out.shape == (64, cfg.output_dim)


def _counted(fn):
    before = profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("test.encode"):
            fn()
    return profiling.counters_since(before).get("test.encode", {})


def test_plain_calls_are_counted_while_tracing():
    cfg = _config({})
    tabs, x = _tables(cfg), _points(cfg, 32)

    def two_calls():
        hg.hash_grid_encode(tabs, x, cfg, bound=BOUND)
        hg.hash_grid_encode(tabs, x, dataclasses.replace(cfg, backend="xla"), bound=BOUND)

    got = _counted(two_calls)
    assert got.get("grid_encode_plain_calls") == 2
    assert "grid_encode_kernel_calls" not in got
    assert not _counted(lambda: None).get("grid_encode_plain_calls")


# ---- on the card ----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hash-grid kernel needs one")
    return torch.device("cuda", 0)


def _close(got, want, rel, what):
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert err <= rel * max(scale, 1e-30), f"{what}: max |kernel - plain| {err} of {scale}"


def _both(cfg, tabs, x, g=None):
    """The kernel's and the plain version's outputs and, with g, the
    gradients of (out * g).sum() in x and in each table."""
    res = []
    for c in (cfg, dataclasses.replace(cfg, backend="xla")):
        ts = [t.detach().clone().requires_grad_(g is not None and t.is_floating_point()
                                                and t.dtype == torch.float32)
              for t in tabs]
        xs = x.detach().clone().requires_grad_(g is not None)
        out = hg.hash_grid_encode(ts, xs, c, bound=BOUND)
        grads = None
        if g is not None:
            grads = torch.autograd.grad((out * g).sum(), [xs, *ts])
        res.append((out.detach(), grads))
    torch.cuda.synchronize()
    return res


@pytest.mark.card
@pytest.mark.parametrize("n", [0, 1, 4099])
@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_kernel_forward_matches_the_plain_version(name, kw, n):
    dev = _card()
    cfg = _config(kw)
    tabs, x = _tables(cfg, device=dev), _points(cfg, n, device=dev)
    (got, _), (want, _) = _both(cfg, tabs, x)
    _close(got, want, 1e-6, f"{name} N={n}")
    if "bf16" not in name:  # bf16 tables, as the eval render casts them
        (got, _), (want, _) = _both(cfg, [t.bfloat16() for t in tabs], x)
        _close(got, want, 1e-6, f"{name} N={n}, bf16 tables")


def _cpu_sum_in_kernel_order(k, f):
    """Whether torch's CPU sum over dim 1 of an (N, k, f) float32 tensor,
    the plain version's sum over corners, takes the order csrc/hashgrid.cu's
    corner_sum pins: at 8 corners and F = 2 or 8 the pairs t_c + t_{c+4}
    added in order, else corner by corner."""
    t = torch.as_tensor(np.random.default_rng(7).uniform(-1, 1, (4099, k, f))
                        .astype(np.float32))
    if k == 8 and f in (2, 8):
        want = (((t[:, 0] + t[:, 4]) + (t[:, 1] + t[:, 5])) + (t[:, 2] + t[:, 6])) \
            + (t[:, 3] + t[:, 7])
    else:
        want = t[:, 0]
        for c in range(1, k):
            want = want + t[:, c]
    return torch.equal(t.sum(dim=1), want)


def _skip_unless_cpu_sums_in_kernel_order(cfg):
    k, f = 2**cfg.input_dim, cfg.level_dim
    if not _cpu_sum_in_kernel_order(k, f):
        pytest.skip(f"torch {torch.__version__}'s CPU sum over {k} corners at F = {f} "
                    f"({torch.backends.cpu.get_cpu_capability()}) takes another order than "
                    "the kernel's corner_sum, which pins the order read on torch 2.13 and "
                    "2.11 with AVX-512: the features cannot be compared bit for bit here")


@pytest.mark.card
@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_kernel_forward_equals_the_cpu_bit_for_bit(name, kw):
    dev = _card()
    cfg = _config(kw)
    _skip_unless_cpu_sums_in_kernel_order(cfg)
    tabs, x = _tables(cfg), _points(cfg, 4099)
    for ts in (tabs, [t.bfloat16() for t in tabs]):
        want = hg.hash_grid_encode(ts, x, cfg, bound=BOUND)  # the CPU: the plain version
        got = hg.hash_grid_encode([t.to(dev) for t in ts], x.to(dev), cfg, bound=BOUND)
        assert torch.equal(got.cpu(), want), f"{name} {ts[0].dtype}"


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 4099])
@pytest.mark.parametrize("name,kw", F32_CASES, ids=[c[0] for c in F32_CASES])
def test_kernel_gradients_match_the_plain_version(name, kw, n):
    dev = _card()
    cfg = _config(kw)
    tabs, x = _tables(cfg, device=dev), _points(cfg, n, device=dev)
    g = torch.randn((n, cfg.output_dim), generator=torch.Generator().manual_seed(3)).to(dev)
    (_, got), (_, want) = _both(cfg, tabs, x, g)
    _close(got[0], want[0], 1e-5, f"{name} dx")
    assert want[0].abs().max() > 0
    for level, (a, b) in enumerate(zip(got[1:], want[1:])):
        _close(a, b, 1e-5, f"{name} table {level}")


@pytest.mark.card
@pytest.mark.parametrize("n", [2**20])
def test_kernel_at_the_benchmark_grid(n):
    """The benchmark's grid (16 x 2 at 2^19, 16 to 2048): enough points that
    the coarse dense levels are summed in shared memory."""
    dev = _card()
    cfg = hg.HashGridConfig(num_levels=16, level_dim=2, base_resolution=16,
                            log2_hashmap_size=19, desired_resolution=2048, backend="fused")
    gen = torch.Generator().manual_seed(4)
    tabs = [(torch.rand((s, 2), generator=gen) * 2e-4 - 1e-4).to(dev) for s in cfg.level_sizes]
    x = ((torch.rand((n, 3), generator=gen) * 2 - 1) * BOUND).to(dev)
    g = torch.randn((n, cfg.output_dim), generator=gen).to(dev)
    (out_k, got), (out_p, want) = _both(cfg, tabs, x, g)
    _close(out_k, out_p, 1e-6, "forward")
    for level, (a, b) in enumerate(zip(got[1:], want[1:])):
        _close(a, b, 1e-5, f"table {level}")
    _skip_unless_cpu_sums_in_kernel_order(cfg)
    m = 1 << 16
    assert torch.equal(out_k[:m].cpu(), hg.hash_grid_encode(
        [t.cpu() for t in tabs], x[:m].cpu(), cfg, bound=BOUND)), "forward vs the CPU"


@pytest.mark.card
@pytest.mark.parametrize("route", ["deterministic mode", "sort"])
@pytest.mark.parametrize("name,kw", [CASES[0], CASES[1]], ids=["corner", "cell"])
def test_kernel_deterministic_route_repeats_bit_for_bit(name, kw, route):
    dev = _card()
    cfg = _config(kw, backward="sort" if route == "sort" else "xla")
    tabs, x = _tables(cfg, device=dev), _points(cfg, 20000, device=dev)
    g = torch.randn((20000, cfg.output_dim), generator=torch.Generator().manual_seed(5)).to(dev)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(route != "sort")
    try:
        runs = [_both(cfg, tabs, x, g)[0][1] for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(*runs):
        assert torch.equal(a, b), name


@pytest.mark.card
def test_kernel_launches_and_counters():
    dev = _card()
    cfg = _config({})
    tabs = [t.requires_grad_() for t in _tables(cfg, device=dev)]
    x = _points(cfg, 100, device=dev)
    start = hg.hash_grid_encode.launches
    out = hg.hash_grid_encode(tabs, x, cfg, bound=BOUND)
    assert hg.hash_grid_encode.launches == start + 1
    out.sum().backward()  # the table gradient
    assert hg.hash_grid_encode.launches == start + 2
    xr = x.clone().requires_grad_()
    hg.hash_grid_encode(tabs, xr, cfg, bound=BOUND).sum().backward()  # and dy/dx
    assert hg.hash_grid_encode.launches == start + 5
    with torch.no_grad():
        hg.hash_grid_encode(tabs, x[:0], cfg, bound=BOUND)  # N = 0 launches nothing
    assert hg.hash_grid_encode.launches == start + 5
    got = _counted(lambda: hg.hash_grid_encode(tabs, x, cfg, bound=BOUND))
    assert got.get("grid_encode_kernel_calls") == 1 and "grid_encode_plain_calls" not in got
