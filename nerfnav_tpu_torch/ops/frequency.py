"""Sin/cos positional (frequency) encoding.

Counterpart of nerfnav_tpu/ops/frequency.py. Elementwise math, outside any
kernel as in the reference; autograd gives its gradient. Output layout:
[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(D-1) x), cos(2^(D-1) x)], so the
width is input_dim * (1 + 2 * degree).
"""

import torch

from nerfnav_tpu_torch.device import device_const


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim * (1 + 2 * degree)


def freq_encode(x: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """x: (..., D) -> (..., D * (1 + 2 * degree)); degree <= 0 returns x."""
    if degree <= 0:
        return x
    freqs = device_const([2.0**f for f in range(degree)], x.device).to(x.dtype)
    xb = x[..., None] * freqs  # (..., D, F), exact: powers of two
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-1).reshape(*x.shape[:-1], -1)
    return torch.cat([x, sc], dim=-1)
