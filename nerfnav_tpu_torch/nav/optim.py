"""optax's clip_by_global_norm and adam, written out on lists of tensors.

The planner and the pose filter run optax.chain(clip_by_global_norm(10),
adam(lr)) and optax.adam(lr) in the JAX package; these give the same
updates in the same float32 order, with no host read (the step count is a
host int).
"""

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def clip_by_global_norm(grads, max_norm: float):
    """Unchanged below the global norm, else (g / norm) * max_norm (optax
    selects; torch's clip_grad_norm_ would add 1e-6 to the norm)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    return [torch.where(norm < max_norm, g, (g / norm) * max_norm) for g in grads]


def adam_init(params):
    """(count, mu, nu) for a fresh optimizer."""
    return 0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]


def adam_update(params, grads, state, lr: float):
    """One optax.adam step followed by apply_updates. Returns (params,
    state)."""
    count, mu, nu = state
    count += 1
    bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
    mu = [(1 - B1) * g + B1 * m for g, m in zip(grads, mu)]
    nu = [(1 - B2) * (g * g) + B2 * v for g, v in zip(grads, nu)]
    params = [p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2) + EPS))
              for p, m, v in zip(params, mu, nu)]
    return params, (count, mu, nu)
