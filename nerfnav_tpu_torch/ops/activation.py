"""Density activation: exp with a clamped derivative.

Counterpart of nerfnav_tpu/ops/activation.py (`trunc_exp`, a custom_jvp
there): the forward is a plain exp, the derivative in both modes is
exp(clamp(x, -15, 15)), so huge densities cannot blow up gradients. The
`jvp` rule serves forward-mode callers (`torch.func.jvp`, `jacfwd`), which
the nav stack's LM filter needs; `generate_vmap_rule` lets jacfwd batch the
tangents through it."""

import torch


class TruncExp(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.exp(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))

    @staticmethod
    def jvp(ctx, t):
        (x,) = ctx.saved_tensors
        return t * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return TruncExp.apply(x)
