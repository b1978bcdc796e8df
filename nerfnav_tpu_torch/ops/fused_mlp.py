"""Fully fused MLP forward: the whole bias-free layer stack in one kernel.

Counterpart of nerfnav_tpu/ops/fused_mlp.py, whose Pallas TPU kernel
(`_fused_kernel`) becomes the hand-written CUDA kernel csrc/fused_mlp.cu.
`fused_mlp` launches it for a CUDA tensor and raises if the build or the
launch fails; a CPU tensor goes to `fused_mlp_reference`, the plain version
that the CPU tests and chip_smoke.py hold the kernel against.

Numerics (the reference's `_mlp_math`): the input and weights are rounded to
bf16, each layer accumulates in f32, each hidden activation is rounded back
to bf16, the output activation runs in f32, the output is f32.

Forward only in this slice: the backward (an f32 recompute in the reference)
arrives with training, so inputs that require grad raise.
"""

import ctypes

import torch

from nerfnav_tpu_torch.device import unported

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
MAX_LAYERS = 8
MAX_WIDTH = 256


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


def fused_mlp_reference(x, weights, activation="relu", output_activation="none"):
    """Plain PyTorch version of the kernel (the reference's golden)."""
    return _mlp_math(
        x.to(torch.bfloat16).float(),
        [w.to(torch.bfloat16).float() for w in weights],
        activation,
        output_activation,
    )


def _check(x, weights, activation, output_activation):
    if x.requires_grad or any(w.requires_grad for w in weights):
        raise unported("fused_mlp backward", "B1")
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


def fused_mlp(x, weights, activation="relu", output_activation="none"):
    """x: (N, D_in) -> (N, D_out) float32 through the fused layer stack.

    weights: list of (D_i, D_{i+1}) tensors, at most 8, every width <= 256.
    On a CUDA tensor this launches the kernel on the current stream and adds
    one to `fused_mlp.launches`; on a CPU tensor it runs the plain version."""
    dims = _check(x, weights, activation, output_activation)
    if x.device.type == "cpu":
        return fused_mlp_reference(x, weights, activation, output_activation)
    if x.device.type != "cuda" or any(w.device != x.device for w in weights):
        raise ValueError("fused_mlp needs x and every weight on one CUDA device")
    from nerfnav_tpu_torch import kernels

    lib = kernels.load("fused_mlp")
    # the kernel copies x in 16-byte pieces: a contiguous view can start at
    # any offset, so such a view is copied first
    xf = x.float().contiguous()
    if xf.data_ptr() % 16:
        xf = xf.clone()
    wb = [w.to(torch.bfloat16).contiguous() for w in weights]
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
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: CUDA error {err}")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
