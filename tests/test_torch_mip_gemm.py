"""mip-NeRF's wide layers through nerfnav_tpu_torch/ops/mip_gemm.py.

On the CPU (tier 1): the wrappers take their plain twins, which give the
eager chain's bits: each layer's forward (bias, relu or none, one bf16
rounding, into a column block of a wider buffer or not) and input gradient
(the product, the density head's rank-1 term, the mask from a saved
activation with or without a row stride, the bf16 gradient and the f32
bias-gradient sums) over the published layers' K (96, 256, 352, 288) and
the view layer's 128; `_MipMLP`, composed of them, gives the outputs and
every gradient of the chain it replaced bit for bit (`_chain_mlp` below);
the wrappers raise on a dtype, shape, stride or device they do not take;
the plain calls are counted while tracing and launch nothing.

Marked `card` (each skips without a CUDA card): the kernels of
csrc/mip_gemm.cu against the plain twins on the card at the same shapes and
M = 0, 1, a ragged M and 2^15 + 37. Tolerances, with their reasons:
- bf16 outputs: at most one bf16 step (2^-8 relative, and 2^-24 of the
  largest entry for values near 0) apart, since the kernel's K sum takes
  another order than cuBLAS's and a float32 sum a few ulps off can round to
  the neighbouring bf16 value; at most 1% of the entries may differ at all;
- f32 column sums: 1e-5 of the column's sum of magnitudes, the orders of
  both the K sums and the row sums differing;
- the column sums and outputs of two kernel runs are equal bit for bit (no
  atomics).
This file imports no JAX, so on the card's machine it runs with `python -m
pytest --noconftest tests/test_torch_mip_gemm.py`.
"""

import math

import pytest
import torch

from nerfnav_tpu_torch.models import network as net
from nerfnav_tpu_torch.ops import mip_gemm as mg
from nerfnav_tpu_torch.utils import profiling

BF = torch.bfloat16
# (K, N) of the published layers' forward: the first trunk layer, a trunk
# layer, the skip layer, the view layer
FORWARD = [(96, 256), (256, 256), (352, 256), (288, 128)]
# (K, the weight's rows) of the input gradients: a trunk layer, the skip
# layer (its first 256 rows), the view layer into the bottleneck
DGRAD = [(256, 256), (256, 352), (128, 288)]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _bf(shape, gen, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(BF)


def _layer(k, n, m, seed, device="cpu"):
    gen = _gen(seed)
    a = _bf((m, k), gen).relu()      # a layer input: relu outputs with zeros
    w = _bf((k, n), gen, math.sqrt(2.0 / (k + n)))
    b = (torch.randn(n, generator=gen) * 0.1)
    return a.to(device), w.to(device), b.to(device)


def _counted(fn):
    before = profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("test.mip"):
            out = fn()
    return out, profiling.counters_since(before).get("test.mip", {})


# ------------------------------------------------------------ the eager chain
def _mm32(a, b, bias=None):
    out = a.float() @ b.float()
    return out if bias is None else out + bias


class _ChainMLP(torch.autograd.Function):
    """The eager chain `_MipMLP` ran before the wide layers became one GEMM
    each way: float32 products, then casts, relus, masks and sums as
    separate ops, the skip input concatenated, the input gradient at the
    skip computed over all of its columns and sliced."""

    @staticmethod
    def forward(ctx, x, cond, skip, *params):
        ws = [w.to(BF) for w in params[0::2]]
        bs = params[1::2]
        depth = len(ws) - 4
        n, m = cond.shape[0], x.shape[0]
        x0 = x.to(BF)
        h, ins = x0, []
        for i in range(depth):
            ins.append(h)
            h = _mm32(h, ws[i], bs[i]).to(BF).relu_()
            if i % skip == 0 and i > 0:
                h = torch.cat([h, x0], dim=-1)
        w_s, w_bn, w_v, w_r = ws[depth:]
        b_s, b_bn, b_v, b_r = bs[depth:]
        raw_density = _mm32(h, w_s, b_s)
        bn = _mm32(h, w_bn, b_bn).to(BF)
        pad = -(w_v.shape[0]) % 8
        c = cond.to(BF)[:, None, :].expand(n, m // n, cond.shape[1])
        v_in = torch.cat([bn.reshape(n, m // n, -1), c,
                          torch.zeros((n, m // n, pad), dtype=BF)], dim=-1).reshape(m, -1)
        w_vp = torch.cat([w_v, torch.zeros((pad, w_v.shape[1]), dtype=BF)])
        v = _mm32(v_in, w_vp, b_v).to(BF).relu_()
        ctx.skip, ctx.view_rows = skip, w_v.shape[0]
        ctx.save_for_backward(*ins, h, v_in, v, *ws[:depth], w_s, w_bn, w_vp, w_r)
        return _mm32(v, w_r, b_r), raw_density

    @staticmethod
    def backward(ctx, g_rgb, g_density):
        saved = ctx.saved_tensors
        depth = (len(saved) - 7) // 2
        ins, (h, v_in, v) = saved[:depth], saved[depth:depth + 3]
        ws = saved[depth + 3:2 * depth + 3]
        w_s, w_bn, w_vp, w_r = saved[2 * depth + 3:]
        width = ws[0].shape[1]

        def layer(inp, g):
            g16 = g.to(BF)
            return g16, _mm32(inp.t(), g16), g.sum(dim=0)

        gr, dw_r, db_r = layer(v, g_rgb)
        gv, dw_v, db_v = layer(v_in, _mm32(gr, w_r.t()).masked_fill_(v <= 0, 0.0))
        gbn, dw_bn, db_bn = layer(h, _mm32(gv, w_vp[:width].t()))
        gd, dw_s, db_s = layer(h, g_density)
        g = _mm32(gbn, w_bn.t()) + gd.float() * w_s.float().t()
        trunk = []
        for i in reversed(range(depth)):
            if i % ctx.skip == 0 and i > 0:
                g = g[:, :width]
            out = h if i == depth - 1 else ins[i + 1]
            g16, dw, db = layer(ins[i], g.masked_fill_(out[:, :width] <= 0, 0.0))
            trunk = [dw, db] + trunk
            if i > 0:
                g = _mm32(g16, ws[i].t())
        return (None, None, None, *trunk, dw_s, db_s, dw_bn, db_bn,
                dw_v[:ctx.view_rows], db_v, dw_r, db_r)


def _chain_mlp(params, x, dir_enc, cfg):
    n, t = x.shape[:2]
    flat = [p for k in ("trunk", "sigma", "bottleneck", "view", "rgb") for p in params[k]]
    rgb, density = _ChainMLP.apply(x.reshape(n * t, -1), dir_enc, cfg.skip_layer, *flat)
    return rgb.reshape(n, t, 3), density.reshape(n, t)


def _mlp_outputs(fn, params, cfg, n, t, seed, device="cpu"):
    """Outputs and every parameter's gradient of fn on seeded inputs and
    output gradients, params moved to device."""
    gen = _gen(seed)
    x = torch.randn((n, t, cfg.pos_dim), generator=gen).to(device)
    d = torch.randn((n, cfg.dir_dim), generator=gen).to(device)
    ps = {k: [p.detach().clone().to(device).requires_grad_() for p in v]
          for k, v in params.items()}
    rgb, density = fn(ps, x, d, cfg)
    loss = (rgb * torch.randn(rgb.shape, generator=gen).to(device)).sum() + \
        (density * torch.randn(density.shape, generator=gen).to(device)).sum()
    flat = [p for k in ("trunk", "sigma", "bottleneck", "view", "rgb") for p in ps[k]]
    return [rgb, density, *torch.autograd.grad(loss, flat)]


MLP_CONFIGS = {
    "published": dict(),
    "narrow": dict(net_width=32, net_width_condition=16, max_deg_point=4, deg_view=2),
    "skip-at-the-top": dict(net_width=48, net_depth=7, skip_layer=2, net_width_condition=8),
}


@pytest.mark.parametrize("name", list(MLP_CONFIGS))
def test_mlp_gives_the_chains_outputs_and_gradients_bit_for_bit(name):
    cfg = net.MipNerfConfig(**MLP_CONFIGS[name])
    gen = _gen(1)
    params = net.init_mipnerf(gen, cfg, "cpu")
    # nonzero biases, so that every bias is exercised
    params = {k: [p + 0.01 * torch.randn(p.shape, generator=gen) for p in v]
              for k, v in params.items()}
    n, t = 4, 12
    got = _mlp_outputs(net.mipnerf_mlp, params, cfg, n, t, seed=2)
    want = _mlp_outputs(_chain_mlp, params, cfg, n, t, seed=2)
    assert len(got) == len(want) == 2 + 2 * (cfg.net_depth + 4)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"output {i}"


def test_mlp_runs_every_wide_layer_through_the_wrappers():
    cfg = net.MipNerfConfig(**MLP_CONFIGS["narrow"])
    params = net.init_mipnerf(_gen(1), cfg, "cpu")
    _, counted = _counted(lambda: _mlp_outputs(net.mipnerf_mlp, params, cfg, 2, 8, seed=3))
    # forward: the trunk, the bottleneck and the view layer; backward: the
    # bottleneck's, the top trunk layer's and each trunk layer's but the first
    assert counted["mip_gemm_plain_calls"] == (cfg.net_depth + 2) + (cfg.net_depth + 1)
    assert "mip_gemm_kernel_calls" not in counted


# ------------------------------------------------------------ the plain twins
@pytest.mark.parametrize("strided", [False, True], ids=["new", "column-block"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "none"])
@pytest.mark.parametrize("k,n", FORWARD, ids=[f"k{k}-n{n}" for k, n in FORWARD])
def test_bias_act_gives_the_chains_bits(k, n, relu, strided):
    a, w, b = _layer(k, n, 203, seed=k + n)
    want = _mm32(a, w, b).to(BF)
    want = want.relu_() if relu else want
    if strided:
        buf = torch.full((203, n + 40), 7.0, dtype=BF)
        got = mg.gemm_bias_act(a, w, b, relu=relu, out=buf[:, 8:8 + n])
        assert got.data_ptr() == buf[:, 8:].data_ptr()
        assert (buf[:, :8] == 7).all() and (buf[:, 8 + n:] == 7).all()
    else:
        got = mg.gemm_bias_act(a, w, b, relu=relu)
    assert got.dtype == BF and torch.equal(got, want)
    assert torch.equal(got, mg.gemm_bias_act_plain(a, w, b, relu))


@pytest.mark.parametrize("a_strided", [False, True], ids=["a", "a-column-block"])
def test_bias_act_reads_a_column_block(a_strided):
    """The first trunk layer reads x0 where it lies in the skip buffer."""
    a, w, b = _layer(96, 256, 77, seed=5)
    if a_strided:
        buf = torch.zeros((77, 352), dtype=BF)
        buf[:, 256:] = a
        a = buf[:, 256:]
    assert torch.equal(mg.gemm_bias_act(a, w, b), _mm32(a, w, b).to(BF).relu_())


@pytest.mark.parametrize("rows", [283, 288], ids=["w283", "w288"])
def test_bias_act_reads_missing_weight_rows_as_zeros(rows):
    """The view layer: a's 288 columns (283 and zero padding) against its
    283-row weight, as the chain's zero-padded 288-row weight gives them."""
    gen = _gen(rows)
    a = _bf((57, 288), gen).relu()
    a[:, 283:] = 0
    w = _bf((rows, 128), gen, 0.1)
    b = torch.randn(128, generator=gen) * 0.1
    w_pad = torch.cat([w, torch.zeros((288 - rows, 128), dtype=BF)])
    assert torch.equal(mg.gemm_bias_act(a, w, b), _mm32(a, w_pad, b).to(BF).relu_())


@pytest.mark.parametrize("saved_kind", ["none", "own", "skip-buffer"])
@pytest.mark.parametrize("rank1", [False, True], ids=["", "rank1"])
@pytest.mark.parametrize("k,rows", DGRAD, ids=[f"k{k}-w{r}" for k, r in DGRAD])
def test_dgrad_mask_gives_the_chains_bits(k, rows, rank1, saved_kind):
    m, n = 211, 256
    gen = _gen(k + rows)
    g = _bf((m, k), gen)
    w_full = _bf((rows, k), gen, 0.1)
    saved = None
    if saved_kind != "none":
        act = _bf((m, n + (96 if saved_kind == "skip-buffer" else 0)), gen).relu()
        saved = act[:, :n]
    r1 = (_bf((m, 1), gen), _bf((rows, 1), gen)) if rank1 else None
    # the chain: the product over all the weight's rows, then sliced
    d = _mm32(g, w_full.t())
    if r1 is not None:
        d = d + r1[0].float() * r1[1].float().t()
    d = d[:, :n]
    if saved is not None:
        d = d.masked_fill(saved <= 0, 0.0)
    got16, got_sum = mg.gemm_dgrad_mask(g, w_full[:n], saved=saved,
                                        rank1=None if r1 is None else (r1[0], r1[1][:n]))
    assert got16.dtype == BF and torch.equal(got16, d.to(BF))
    assert got_sum.dtype == torch.float32 and torch.equal(got_sum, d.sum(dim=0))


# ------------------------------------------------------------ the checks
def _bad_bias_act():
    a, w, b = _layer(96, 256, 8, seed=0)
    meta = torch.device("meta")
    return {
        "a-float32": (a.float(), w, b, None),
        "a-1d": (a[0], w, b, None),
        "w-wrong-k": (a, torch.cat([w, w]), b, None),
        "w-float32": (a, w.float(), b, None),
        "bias-bf16": (a, w, b.to(BF), None),
        "bias-wrong-n": (a, w, b[:128], None),
        "out-wrong-shape": (a, w, b, torch.empty((8, 128), dtype=BF)),
        "out-float32": (a, w, b, torch.empty((8, 256))),
        "out-column-stride": (a, w, b, torch.empty((256, 8), dtype=BF).t()),
        "a-column-stride": (torch.empty((96, 8), dtype=BF).t(), w, b, None),
        "w-other-device": (a, w.to(meta), b, None),
        "bias-other-device": (a, w, b.to(meta), None),
    }


@pytest.mark.parametrize("case", list(_bad_bias_act()))
def test_bias_act_raises_on_what_it_does_not_take(case):
    a, w, b, out = _bad_bias_act()[case]
    with pytest.raises(ValueError):
        mg.gemm_bias_act(a, w, b, out=out)


def _bad_dgrad():
    gen = _gen(0)
    g, w = _bf((8, 256), gen), _bf((256, 256), gen)
    saved, gd, ws = _bf((8, 256), gen), _bf((8, 1), gen), _bf((256, 1), gen)
    meta = torch.device("meta")
    return {
        "g-float32": (g.float(), w, saved, None),
        "w-wrong-k": (g, w[:, :128], saved, None),
        "w-float32": (g, w.float(), saved, None),
        "w-column-stride": (g, torch.empty((256, 256), dtype=BF).t()[:, :], saved, None),
        "saved-wrong-shape": (g, w, saved[:, :128], None),
        "saved-float32": (g, w, saved.float(), None),
        "saved-column-stride": (g, w, torch.empty((256, 8), dtype=BF).t(), None),
        "gd-wrong-shape": (g, w, saved, (gd[:4], ws)),
        "ws-float32": (g, w, saved, (gd, ws.float())),
        "saved-other-device": (g, w, saved.to(meta), None),
        "w-other-device": (g, w.to(meta), saved, None),
    }


@pytest.mark.parametrize("case", list(_bad_dgrad()))
def test_dgrad_mask_raises_on_what_it_does_not_take(case):
    g, w, saved, rank1 = _bad_dgrad()[case]
    with pytest.raises(ValueError):
        mg.gemm_dgrad_mask(g, w, saved=saved, rank1=rank1)


# ------------------------------------------------------------ the counts
@pytest.mark.parametrize("which", ["bias_act", "dgrad_mask"])
def test_plain_calls_are_counted_and_launch_nothing(which):
    a, w, b = _layer(256, 256, 16, seed=9)
    before = (mg.gemm_bias_act.launches, mg.gemm_dgrad_mask.launches)

    def two_calls():
        for _ in range(2):
            if which == "bias_act":
                mg.gemm_bias_act(a, w, b)
            else:
                mg.gemm_dgrad_mask(a, w, saved=a)

    _, counted = _counted(two_calls)
    assert counted.get("mip_gemm_plain_calls") == 2
    assert "mip_gemm_kernel_calls" not in counted
    assert (mg.gemm_bias_act.launches, mg.gemm_dgrad_mask.launches) == before
    _, untraced = _counted(lambda: None)
    assert not untraced.get("mip_gemm_plain_calls")


# ---- on the card ----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the mip GEMM kernel needs one")
    return torch.device("cuda", 0)


def _one_step_apart(got, want, what):
    """bf16 tensors at most one bf16 step apart (see the module's
    docstring), and equal in at least 99% of the entries."""
    assert got.shape == want.shape and got.dtype == want.dtype == BF, what
    g, w = got.float(), want.float()
    scale = float(w.abs().max()) if w.numel() else 0.0
    diff = (g - w).abs()
    allowed = torch.maximum(g.abs(), w.abs()) * 2.0**-8 + scale * 2.0**-24
    worst = float((diff - allowed).max()) if w.numel() else 0.0
    assert worst <= 0, f"{what}: an entry more than one bf16 step off ({worst})"
    share = float((diff > 0).float().mean()) if w.numel() else 0.0
    assert share <= 0.01, f"{what}: {share:.4f} of the entries differ"


M_CARD = [0, 1, 4099, 2**15 + 37]


@pytest.mark.card
@pytest.mark.parametrize("m", M_CARD)
@pytest.mark.parametrize("strided", [False, True], ids=["new", "column-block"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "none"])
@pytest.mark.parametrize("k,n", FORWARD, ids=[f"k{k}-n{n}" for k, n in FORWARD])
def test_kernel_bias_act_matches_the_plain_twin(k, n, relu, strided, m):
    dev = _card()
    a, w, b = _layer(k, n, m, seed=k + n + m, device=dev)
    before = mg.gemm_bias_act.launches
    if strided:
        buf = torch.full((m, n + 96), 7.0, dtype=BF, device=dev)
        got = mg.gemm_bias_act(a, w, b, relu=relu, out=buf[:, :n])
        assert (buf[:, n:] == 7).all()
    else:
        got = mg.gemm_bias_act(a, w, b, relu=relu)
    assert mg.gemm_bias_act.launches == before + (1 if m else 0)
    torch.cuda.synchronize()
    _one_step_apart(got, mg.gemm_bias_act_plain(a, w, b, relu), f"bias_act k{k} n{n} m{m}")


def _dgrad_inputs(k, rows, m, rank1, saved_kind, dev):
    gen = _gen(k + rows + m)
    g = _bf((m, k), gen).to(dev)
    w = _bf((rows, k), gen, math.sqrt(2.0 / (k + rows))).to(dev)[:256]
    saved = None
    if saved_kind != "none":
        extra = 96 if saved_kind == "skip-buffer" else 0
        saved = _bf((m, 256 + extra), gen).relu().to(dev)[:, :256]
    r1 = (_bf((m, 1), gen).to(dev), _bf((256, 1), gen).to(dev)) if rank1 else None
    return g, w, saved, r1


@pytest.mark.card
@pytest.mark.parametrize("m", M_CARD)
@pytest.mark.parametrize("saved_kind", ["none", "own", "skip-buffer"])
@pytest.mark.parametrize("rank1", [False, True], ids=["", "rank1"])
@pytest.mark.parametrize("k,rows", DGRAD, ids=[f"k{k}-w{r}" for k, r in DGRAD])
def test_kernel_dgrad_mask_matches_the_plain_twin(k, rows, rank1, saved_kind, m):
    dev = _card()
    g, w, saved, r1 = _dgrad_inputs(k, rows, m, rank1, saved_kind, dev)
    before = mg.gemm_dgrad_mask.launches
    got16, got_sum = mg.gemm_dgrad_mask(g, w, saved=saved, rank1=r1)
    assert mg.gemm_dgrad_mask.launches == before + (1 if m else 0)
    want16, want_sum = mg.gemm_dgrad_mask_plain(g, w, saved, r1)
    torch.cuda.synchronize()
    _one_step_apart(got16, want16, f"dgrad k{k} m{m}")
    d = mg.mm32(g, w.t())
    if r1 is not None:
        d = d + r1[0].float() * r1[1].float().t()
    if saved is not None:
        d.masked_fill_(saved <= 0, 0.0)
    mags = d.abs().sum(dim=0)
    assert got_sum.dtype == torch.float32 and got_sum.shape == (256,)
    assert bool(((got_sum - want_sum).abs() <= 1e-5 * mags + 1e-30).all()), \
        f"dgrad k{k} m{m}: column sums {float((got_sum - want_sum).abs().max())} off"
    again16, again_sum = mg.gemm_dgrad_mask(g, w, saved=saved, rank1=r1)
    assert torch.equal(again16, got16) and torch.equal(again_sum, got_sum)


@pytest.mark.card
@pytest.mark.parametrize("what", ["a", "out", "saved", "k-deep", "k-odd", "n"])
def test_kernel_raises_on_what_it_does_not_take(what):
    """On the card the kernel moves 16 bytes a thread (a matrix that starts
    off a 16-byte boundary or has a row stride off 8 elements is refused),
    keeps B in shared memory (K up to 384 at N = 256) and takes N 256 or
    128."""
    dev = _card()
    a, w, b = _layer(256, 256, 64, seed=6, device=dev)
    wide = torch.zeros((64, 264), dtype=BF, device=dev)
    with pytest.raises(ValueError):
        if what == "a":
            mg.gemm_bias_act(wide[:, 4:260].copy_(a), w, b)
        elif what == "out":
            mg.gemm_bias_act(a, w, b, out=wide[:, 2:258])
        elif what == "saved":
            mg.gemm_dgrad_mask(a, w, saved=wide[:, 4:260])
        elif what == "k-deep":
            mg.gemm_bias_act(*_layer(400, 256, 64, seed=7, device=dev))
        elif what == "k-odd":
            mg.gemm_bias_act(*_layer(104, 256, 64, seed=7, device=dev))
        else:
            mg.gemm_bias_act(*_layer(256, 192, 64, seed=7, device=dev))


@pytest.mark.card
@pytest.mark.parametrize("m", M_CARD)
def test_kernel_reads_missing_weight_rows_as_zeros(m):
    """The view layer as the MLP calls it: a (M, 288) whose last 5 columns
    are zeros, against the 283-row weight W as it lies."""
    dev = _card()
    a, w, b = _layer(288, 128, m, seed=m + 5, device=dev)
    a[:, 283:] = 0
    got = mg.gemm_bias_act(a, w[:283], b)
    torch.cuda.synchronize()
    _one_step_apart(got, mg.gemm_bias_act_plain(a, w[:283], b), f"view rows 283 m{m}")


@pytest.mark.card
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "none"])
def test_kernel_keeps_a_nan_as_the_plain_twin_does(relu):
    """A NaN in a row of A gives NaN in that row's outputs, through the relu
    too (torch's relu keeps a NaN); the other rows are untouched."""
    dev = _card()
    a, w, b = _layer(256, 256, 300, seed=11, device=dev)
    a[7, 3] = float("nan")
    got = mg.gemm_bias_act(a, w, b, relu=relu)
    want = mg.gemm_bias_act_plain(a, w, b, relu)
    torch.cuda.synchronize()
    assert bool(want[7].isnan().all()) and bool(got[7].isnan().all())
    rest = torch.ones(300, dtype=torch.bool, device=dev)
    rest[7] = False
    assert not bool(got[rest].isnan().any())
    _one_step_apart(got[rest], want[rest], "rows without the NaN")


@pytest.mark.card
def test_kernel_calls_are_counted_while_tracing():
    dev = _card()
    a, w, b = _layer(256, 256, 300, seed=4, device=dev)
    _, counted = _counted(lambda: (mg.gemm_bias_act(a, w, b),
                                   mg.gemm_dgrad_mask(a, w.t().contiguous(), saved=a)))
    assert counted.get("mip_gemm_kernel_calls") == 2
    assert "mip_gemm_plain_calls" not in counted


@pytest.mark.card
def test_kernel_mlp_matches_the_plain_twins_on_the_card():
    """The published MLP on the card through the kernels, against the same
    MLP on the CPU through the plain twins: relative to each tensor's
    largest entry, outputs 2e-2 and gradients 5e-2 (bf16 activations whose
    roundings differ by a step in a few places, carried through 8 layers)."""
    dev = _card()
    cfg = net.MipNerfConfig()
    gen = _gen(1)
    params = net.init_mipnerf(gen, cfg, "cpu")
    n, t = 64, 128
    got = _mlp_outputs(net.mipnerf_mlp, params, cfg, n, t, seed=2, device=dev)
    want = _mlp_outputs(net.mipnerf_mlp, params, cfg, n, t, seed=2)
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.cpu()
        scale = float(b.abs().max())
        tol = 2e-2 if i < 2 else 5e-2
        assert float((a - b).abs().max()) <= tol * scale, f"output {i}"
