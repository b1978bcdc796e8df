"""Training losses: MAPE, Huber and the O(N) distortion loss.

Counterpart of nerfnav_tpu/ops/losses.py. Autograd of the closed forms below
gives the reference's gradients (the distortion loss needs no custom
backward). The trainer's criterion stays the plain MSE.
"""

import torch


def mape_loss(pred, target, reduction: str = "mean"):
    """Mean absolute percentage error; the denominator is detached."""
    difference = (pred - target).float()
    scale = 1.0 / (target.detach().abs() + 1e-2)
    loss = difference.abs() * scale
    return loss.mean() if reduction == "mean" else loss


def huber_loss(pred, target, delta: float = 0.1, reduction: str = "mean"):
    rel = (pred - target).abs().float()
    sqr = (0.5 / delta) * rel * rel
    loss = torch.where(rel > delta, rel - 0.5 * delta, sqr)
    return loss.mean() if reduction == "mean" else loss


def eff_distloss(w, t, interval):
    """Distortion loss of mip-NeRF 360 in O(N) by prefix sums.

    w, t: (..., N) weights and ascending midpoints; interval: a scalar or
    (..., N) bin widths. Mean over the leading axes of
    sum_ij w_i w_j |t_i - t_j| + (1/3) sum_i w_i^2 interval_i."""
    wm = w * t
    w_prev = torch.cumsum(w, dim=-1) - w
    wm_prev = torch.cumsum(wm, dim=-1) - wm
    cross = 2.0 * (w * (t * w_prev - wm_prev)).sum(dim=-1)
    self_term = (w * w * interval).sum(dim=-1) / 3.0
    return (cross + self_term).mean()
