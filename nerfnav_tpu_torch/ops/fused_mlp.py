"""Fully fused MLP forward: the whole bias-free layer stack in one kernel.

Counterpart of nerfnav_tpu/ops/fused_mlp.py, whose Pallas TPU kernel
(`_fused_kernel`) becomes the hand-written CUDA kernel csrc/fused_mlp.cu.
`fused_mlp` launches it for a CUDA tensor and raises if the build or the
launch fails; a CPU tensor goes to `fused_mlp_reference`, the plain version
that the CPU tests and chip_smoke.py hold the kernel against.

Numerics (the reference's `_mlp_math`): the input and weights are rounded to
bf16, each layer accumulates in f32, each hidden activation is rounded back
to bf16, the output activation runs in f32, the output is f32.

The backward is the reference's custom_vjp (`_fused_mlp_bwd`), which
recomputes the layer stack on bf16-rounded x and weights and chains the
matmul gradients with the reference's rounding points; `_mlp_backward` is its
plain version. On a CUDA tensor of a net the backward kernel takes
(`backward_takes_kernel`: widths up to 64, a relu or none hidden activation)
it runs as the kernel pair of csrc/fused_mlp.cu, which computes the same
function and differs only in the order of its f32 sums; every other call,
and every CPU call, runs `_mlp_backward`. Each backward counts
`fused_mlp_bwd_kernel_calls` or `fused_mlp_bwd_plain_calls` in the innermost
span while tracing; `fused_mlp.bwd_launches` counts the kernel calls.
"""

import ctypes

import torch

from nerfnav_tpu_torch.utils.profiling import count

_ACTIVATIONS = {
    "relu": torch.relu,
    "none": lambda x: x,
    "exp": torch.exp,
    "sigmoid": torch.sigmoid,
    "sine": torch.sin,
    "squareplus": lambda x: 0.5 * (x + torch.sqrt(x * x + 4.0)),
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
}
_ACT_IDS = {name: i for i, name in enumerate(_ACTIVATIONS)}
# d act(x) / dx times g, as the reference's autodiff takes it; jnp.maximum
# splits the gradient at a tie, so relu passes half of it at x == 0
_ACT_GRADS = {
    "relu": lambda x, g: torch.where(x > 0, g, torch.where(x == 0, 0.5 * g, 0.0)),
    "none": lambda x, g: g,
    "exp": lambda x, g: g * torch.exp(x),
    "sigmoid": lambda x, g: g * torch.sigmoid(x) * (1.0 - torch.sigmoid(x)),
    "sine": lambda x, g: g * torch.cos(x),
    "squareplus": lambda x, g: 0.5 * g * (1.0 + x / torch.sqrt(x * x + 4.0)),
    "softplus": lambda x, g: g * torch.sigmoid(x),
}
MAX_LAYERS = 8
MAX_WIDTH = 256
BWD_MAX_WIDTH = 64                   # the backward kernel's widest layer
_BWD_HIDDEN = ("relu", "none")       # the backward kernel's hidden activations


def _mlp_math(x, weights, activation, output_activation):
    """The reference's layer stack on bf16-valued f32 tensors: products of
    bf16 values accumulated in f32, with no rounding of the matmul output."""
    act = _ACTIVATIONS[activation]
    out_act = _ACTIVATIONS[output_activation]
    h = x
    for i, w in enumerate(weights):
        h = h @ w
        if i < len(weights) - 1:
            h = act(h).to(torch.bfloat16).float()
        else:
            h = out_act(h)
    return h


def _bf16(t):
    return t.to(torch.bfloat16).float()


def fused_mlp_reference(x, weights, activation="relu", output_activation="none"):
    """Plain PyTorch version of the kernel (the reference's golden)."""
    return _mlp_math(_bf16(x), [_bf16(w) for w in weights], activation,
                     output_activation)


def _mlp_backward(x, weights, g, activation, output_activation):
    """(dx, [dW]) of the reference's VJP of `_mlp_math` on bf16-rounded x
    and weights. Each dot's transpose returns its cotangent in its operand's
    dtype, bf16: every dh and dW is rounded to bf16, then taken back to f32."""
    hs = [_bf16(x)]
    ws = [_bf16(w) for w in weights]
    pres = []
    for i, w in enumerate(ws):
        pres.append(hs[-1] @ w)
        if i < len(ws) - 1:
            hs.append(_bf16(_ACTIVATIONS[activation](pres[-1])))
    gp = _ACT_GRADS[output_activation](pres[-1], g.float())
    dws = [None] * len(ws)
    for i in range(len(ws) - 1, -1, -1):
        dws[i] = _bf16(hs[i].T @ gp)
        dh = _bf16(gp @ ws[i].T)
        if i > 0:
            gp = _ACT_GRADS[activation](pres[i - 1], dh)
    return dh.to(x.dtype), [dw.to(w.dtype) for dw, w in zip(dws, weights)]


def _check(x, weights, activation, output_activation):
    if activation not in _ACTIVATIONS or output_activation not in _ACTIVATIONS:
        raise ValueError(
            f"activations must be in {sorted(_ACTIVATIONS)}, got "
            f"{activation!r} / {output_activation!r}")
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"fused_mlp takes 1..{MAX_LAYERS} layers, got {len(weights)}")
    if x.dim() != 2:
        raise ValueError(f"x must be (N, D_in), got {tuple(x.shape)}")
    dims = [x.shape[1]]
    for w in weights:
        if w.dim() != 2 or w.shape[0] != dims[-1]:
            raise ValueError(
                f"weight {tuple(w.shape)} does not follow width {dims[-1]}")
        dims.append(w.shape[1])
    if not all(1 <= d <= MAX_WIDTH for d in dims):
        raise ValueError(f"fused_mlp widths must be in 1..{MAX_WIDTH}, got {dims}")
    return dims


def backward_takes_kernel(dims, activation):
    """True for the nets the backward kernel takes on a CUDA tensor: every
    width at most BWD_MAX_WIDTH and a relu or none hidden activation (with
    any output activation and 1 to MAX_LAYERS layers, as every fused net)."""
    return max(dims) <= BWD_MAX_WIDTH and activation in _BWD_HIDDEN


def _aligned_f32(t):
    """t as a contiguous float32 tensor starting 16-byte aligned: the kernels
    copy rows in 16-byte pieces, and a contiguous view can start at any
    offset, so such a view is copied first."""
    t = t.float().contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _checked(err, what):
    if err != 0:
        raise RuntimeError(f"fused_mlp {what} failed: CUDA error {err}")


def _launch(x, wb, dims, activation, output_activation):
    """Run the kernel on x's CUDA device with the bf16 weights wb; adds one
    to `fused_mlp.launches`."""
    from nerfnav_tpu_torch import kernels

    lib = kernels.load("fused_mlp")
    xf = _aligned_f32(x)
    out = torch.empty((x.shape[0], dims[-1]), device=x.device, dtype=torch.float32)
    if x.shape[0] == 0:
        return out
    w_ptrs = (ctypes.c_void_p * len(wb))(*[w.data_ptr() for w in wb])
    c_dims = (ctypes.c_int * len(dims))(*dims)
    err = lib.nerfnav_fused_mlp_forward(
        xf.data_ptr(), ctypes.addressof(w_ptrs), out.data_ptr(), x.shape[0],
        len(wb), ctypes.addressof(c_dims), _ACT_IDS[activation],
        _ACT_IDS[output_activation],
        torch.cuda.current_stream(x.device).cuda_stream)
    _checked(err, "kernel launch")
    fused_mlp.launches += 1
    return out


def _launch_backward(x, wb, g, dims, activation, output_activation):
    """(dx, [dW]) in float32 from the backward kernel pair on x's CUDA device,
    with the bf16 weights wb the forward used; adds one to
    `fused_mlp.bwd_launches`."""
    from nerfnav_tpu_torch import kernels

    n = x.shape[0]
    sizes = [a * b for a, b in zip(dims[:-1], dims[1:])]
    dx = torch.empty((n, dims[0]), device=x.device, dtype=torch.float32)
    dw = (torch.empty if n else torch.zeros)(sum(sizes), device=x.device, dtype=torch.float32)
    if n:
        lib = kernels.load("fused_mlp")
        xf, gf = _aligned_f32(x), _aligned_f32(g)
        c_dims = (ctypes.c_int * len(dims))(*dims)
        need = ctypes.c_longlong()
        _checked(lib.nerfnav_fused_mlp_backward_scratch(
            n, len(wb), ctypes.addressof(c_dims), ctypes.addressof(need)), "backward plan")
        scratch = torch.empty(need.value, device=x.device, dtype=torch.float32)
        w_ptrs = (ctypes.c_void_p * len(wb))(*[w.data_ptr() for w in wb])
        _checked(lib.nerfnav_fused_mlp_backward(
            xf.data_ptr(), gf.data_ptr(), ctypes.addressof(w_ptrs), dx.data_ptr(),
            dw.data_ptr(), scratch.data_ptr(), need.value, n, len(wb),
            ctypes.addressof(c_dims), _ACT_IDS[activation], _ACT_IDS[output_activation],
            torch.cuda.current_stream(x.device).cuda_stream), "backward kernel launch")
        fused_mlp.bwd_launches += 1
    dws = [d.view(a, b) for d, a, b in zip(dw.split(sizes), dims[:-1], dims[1:])]
    return dx, dws


def _backward(x, weights, wb, g, dims, activation, output_activation):
    """(dx, [dW]) in x's and the weights' dtypes: the kernel pair for a
    tensor off the CPU (the forward takes CUDA tensors only) of a net
    `backward_takes_kernel` takes, else `_mlp_backward`. Counts the call in
    the innermost span while tracing."""
    if x.device.type != "cpu" and backward_takes_kernel(dims, activation):
        count("fused_mlp_bwd_kernel_calls", 1)
        dx, dws = _launch_backward(x, wb, g, dims, activation, output_activation)
        return dx.to(x.dtype), [d.to(w.dtype) for d, w in zip(dws, weights)]
    count("fused_mlp_bwd_plain_calls", 1)
    return _mlp_backward(x, weights, g, activation, output_activation)


class _FusedMLP(torch.autograd.Function):
    """The kernel's forward (the plain version for a CPU tensor) and the
    reference's recompute backward (`_backward`)."""

    @staticmethod
    def forward(ctx, x, dims, activation, output_activation, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.acts = (activation, output_activation)
        ctx.dims = dims
        ctx.wb = None  # the bf16 weights the kernel ran with, for its backward
        if x.device.type == "cpu":
            return fused_mlp_reference(x, weights, activation, output_activation)
        if x.device.type != "cuda" or any(w.device != x.device for w in weights):
            raise ValueError("fused_mlp needs x and every weight on one CUDA device")
        ctx.wb = [w.to(torch.bfloat16).contiguous() for w in weights]
        return _launch(x, ctx.wb, dims, activation, output_activation)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        dx, dws = _backward(x, weights, ctx.wb, g, ctx.dims, *ctx.acts)
        return (dx, None, None, None, *dws)


def fused_mlp(x, weights, activation="relu", output_activation="none"):
    """x: (N, D_in) -> (N, D_out) float32 through the fused layer stack.

    weights: list of (D_i, D_{i+1}) tensors, at most 8, every width <= 256.
    On a CUDA tensor the forward launches the kernel on the current stream
    and adds one to `fused_mlp.launches`; on a CPU tensor it runs the plain
    version. Differentiable in x and the weights (see `_backward`)."""
    dims = _check(x, weights, activation, output_activation)
    return _FusedMLP.apply(x, dims, activation, output_activation, *weights)


fused_mlp.launches = 0
fused_mlp.bwd_launches = 0
