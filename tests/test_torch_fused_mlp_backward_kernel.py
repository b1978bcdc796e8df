"""The fused MLP's backward kernel pair (csrc/fused_mlp.cu,
`nerfnav_fused_mlp_backward`) against its plain version `_mlp_backward`.

Marked `card` (each skips without a CUDA card): the three nets the port
builds (sigma 32-64-16, color 31-64-64-3, bg 24-64-3) at N = 1, 127, 128,
129, 65,536 and 2,097,152 (a dense train step's), x starting one color row
(124 bytes) into its buffer, zero rows of x (exact-zero pre-activations,
where relu passes half the gradient), the output gradient kept in f32, two
launches bit for bit, N = 0, the other activations and the deepest net the
kernel takes, and the route and counters through autograd.

Tolerance: dx and every dW within 2e-3 in relative L2 norm of the plain
version on the card (half a bf16 step): both round at the same points, and
only the order of the f32 sums differs, which moves a bf16 rounding in a
few entries at most. Through nets of more than 3 layers the moved roundings
compound (tests/test_torch_grad.py): there L bf16 steps (L 2^-8) for L
layers. The CPU routes and counters are tier-1 tests in
tests/test_torch_ops.py. This file imports no JAX, so on the card's machine
it runs with `python -m pytest --noconftest -m card
tests/test_torch_fused_mlp_backward_kernel.py`.
"""

import pytest
import torch

from nerfnav_tpu_torch.ops import fused_mlp as fm
from nerfnav_tpu_torch.utils import profiling

NETS = {"sigma": [32, 64, 16], "color": [31, 64, 64, 3], "bg": [24, 64, 3]}
ROWS = (1, 127, 128, 129, 65536, 2097152)
TOL = 2e-3
BF16_STEP = 2.0**-8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the fused MLP's backward kernel needs one")
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.skip("the plain version needs full float32 matmuls (allow_tf32 is set)")
    return torch.device("cuda", 0)


def _inputs(dims, n, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, dims[0]), generator=gen, device=dev)
    ws = [(torch.rand((a, b), generator=gen, device=dev) * 2 - 1) / a**0.5
          for a, b in zip(dims[:-1], dims[1:])]
    g = torch.randn((n, dims[-1]), generator=gen, device=dev)
    return x, ws, g


def _kernel(x, ws, g, act="relu", out_act="none"):
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    wb = [w.to(torch.bfloat16) for w in ws]
    dx, dws = fm._launch_backward(x, wb, g, dims, act, out_act)
    torch.cuda.synchronize()
    return [dx, *dws]


def _plain(x, ws, g, act="relu", out_act="none"):
    dx, dws = fm._mlp_backward(x, ws, g, act, out_act)
    return [dx, *dws]


def _tol(dims):
    layers = len(dims) - 1
    return TOL if layers <= 3 else layers * BF16_STEP


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _assert_close(got, want, tol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        name = "dx" if i == 0 else f"dW{i - 1}"
        assert a.shape == b.shape and a.dtype == torch.float32, f"{what} {name}"
        assert bool(torch.isfinite(a).all()), f"{what} {name}: not finite"
        err = _rel_l2(a, b)
        assert err <= tol, f"{what} {name}: relative L2 {err:.3g} > {tol}"


@pytest.mark.card
@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("net", NETS)
def test_backward_matches_plain(net, n):
    dev = _card()
    x, ws, g = _inputs(NETS[net], n, dev, seed=n + len(net))
    _assert_close(_kernel(x, ws, g), _plain(x, ws, g), TOL, f"{net} N={n}")


@pytest.mark.card
def test_x_one_color_row_into_its_buffer():
    dev = _card()
    x, ws, g = _inputs(NETS["color"], 1001, dev, seed=3)
    x = x[1:]  # starts 124 bytes in: the wrapper copies it to a 16-byte start
    assert x.data_ptr() % 16
    _assert_close(_kernel(x, ws, g[1:]), _plain(x, ws, g[1:]), TOL, "misaligned x")


@pytest.mark.card
@pytest.mark.parametrize("act", ["relu", "none"])
def test_zero_rows_take_half_the_relu_gradient(act):
    """Zero rows of x give pre-activations of exactly 0 in every layer, where
    relu passes half the gradient: dx of those rows is nothing but that."""
    dev = _card()
    x, ws, g = _inputs(NETS["color"], 4096, dev, seed=5)
    x[::3] = 0.0
    got, want = _kernel(x, ws, g, act), _plain(x, ws, g, act)
    _assert_close(got, want, TOL, f"zero rows, {act}")
    rows = got[0][::3]
    assert float(rows.abs().max()) > 0
    assert _rel_l2(rows, want[0][::3]) <= TOL


@pytest.mark.card
def test_output_gradient_stays_float32():
    """g enters the last layer's products in f32 (three exact bf16 terms):
    the kernel is far nearer the plain version on g than on g rounded to
    bf16, which is another result."""
    dev = _card()
    x, ws, g = _inputs(NETS["sigma"], 65536, dev, seed=7)
    got, want = _kernel(x, ws, g), _plain(x, ws, g)
    rounded = _plain(x, ws, g.to(torch.bfloat16).float())
    for i in (0, 2):  # dx, and the last layer's dW
        assert _rel_l2(got[i], want[i]) * 4 < _rel_l2(rounded[i], want[i])


@pytest.mark.card
@pytest.mark.parametrize("net", NETS)
def test_two_launches_are_bit_equal(net):
    dev = _card()
    x, ws, g = _inputs(NETS[net], 300_001, dev, seed=11)
    for a, b in zip(_kernel(x, ws, g), _kernel(x, ws, g)):
        assert torch.equal(a, b)


@pytest.mark.card
def test_no_rows_give_zeros():
    dev = _card()
    x, ws, g = _inputs(NETS["color"], 0, dev, seed=13)
    before = fm.fused_mlp.bwd_launches
    dx, *dws = _kernel(x, ws, g)
    assert fm.fused_mlp.bwd_launches == before
    assert dx.shape == (0, 31)
    assert all(d.shape == w.shape and not d.any() for d, w in zip(dws, ws))


@pytest.mark.card
@pytest.mark.parametrize("out_act", ["exp", "sigmoid", "sine", "squareplus", "softplus", "relu"])
def test_output_activations(out_act):
    dev = _card()
    x, ws, g = _inputs(NETS["color"], 5000, dev, seed=17)
    ws = [w * 0.5 for w in ws]
    _assert_close(_kernel(x, ws, g, "relu", out_act), _plain(x, ws, g, "relu", out_act),
                  TOL, out_act)


@pytest.mark.card
@pytest.mark.parametrize("dims", [[64] * 9, [3, 16, 1], [7, 9, 17, 33, 5], [64, 64]])
def test_other_shapes(dims):
    """The deepest and the narrowest nets the kernel takes, odd widths, one
    layer; the 8 x 64 net's partials do not fit in shared memory."""
    dev = _card()
    x, ws, g = _inputs(dims, 3001, dev, seed=len(dims))
    _assert_close(_kernel(x, ws, g), _plain(x, ws, g), _tol(dims), str(dims))


@pytest.mark.card
@pytest.mark.parametrize("dims,act,kernel", [
    (NETS["sigma"], "relu", True), (NETS["color"], "relu", True), (NETS["bg"], "relu", True),
    ([128] * 9, "relu", False), ([3, 256, 256, 1], "relu", False),
    (NETS["color"], "sigmoid", False)])
def test_autograd_route_and_counters(dims, act, kernel):
    dev = _card()
    x, ws, g = _inputs(dims, 2048, dev, seed=19)
    xr = x.requires_grad_()
    wr = [w.requires_grad_() for w in ws]
    before, counted = fm.fused_mlp.bwd_launches, profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("test.backward"):
            (fm.fused_mlp(xr, wr, act) * g).sum().backward()
    got = profiling.counters_since(counted).get("test.backward", {})
    assert fm.fused_mlp.bwd_launches - before == int(kernel)
    assert got.get("fused_mlp_bwd_kernel_calls", 0) == int(kernel)
    assert got.get("fused_mlp_bwd_plain_calls", 0) == int(not kernel)
    want = _plain(x.detach(), [w.detach() for w in ws], g, act)
    _assert_close([xr.grad, *[w.grad for w in wr]], want, _tol(dims), str(dims))
