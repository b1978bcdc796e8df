"""Density activation: exp, whose derivative (clamped to [-15, 15] in the
reference, nerfnav_tpu/ops/activation.py) arrives with training.

Forward only in this slice: an input that requires grad raises rather than
silently differentiating the unclamped exp."""

import torch

from nerfnav_tpu_torch.device import unported


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    if x.requires_grad:
        raise unported("trunc_exp backward (clamped derivative)", "A1")
    return torch.exp(x)
