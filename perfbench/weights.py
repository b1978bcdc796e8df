"""The field's weights, made on the device from the seed at torch-ngp's
initialisation: hash tables U(-1e-4, 1e-4), bias-free layers
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), in the program's parameter layout
(a list of per-level tables under "encoder", lists of (in, out) matrices
under "sigma_net" and "color_net")."""

import numpy as np
import torch

from perfbench.reference import ngp as ref


def make_params(c, gen, device):
    """The field's weights in the program's layout, drawn on the device in
    one call for the tables and one for the layers."""
    rows = ref.level_rows(c)
    tables = torch.rand((sum(rows), c["grid_level_dim"]), generator=gen, device=device)
    tables = tables * 2e-4 - 1e-4
    nets = {"sigma_net": c["sigma_net"], "color_net": c["color_net"]}
    sizes = [a * b for dims in nets.values() for a, b in zip(dims[:-1], dims[1:])]
    flat = torch.rand((sum(sizes),), generator=gen, device=device)
    out = {"encoder": list(torch.split(tables, rows))}
    at = 0
    for key, dims in nets.items():
        out[key] = []
        for a, b in zip(dims[:-1], dims[1:]):
            w = (flat[at:at + a * b].reshape(a, b) * 2.0 - 1.0) / np.sqrt(a)
            out[key].append(w)
            at += a * b
    return out
