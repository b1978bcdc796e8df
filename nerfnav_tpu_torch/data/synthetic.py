"""Analytic fields: closed-form density and color closures as a `Field`.

Counterpart of the field builders of nerfnav_tpu/data/synthetic.py
(`sphere_field`, `cylinder_field`, `textured_sphere_field`,
`cluttered_field`): the `--analytic` nav scene and the tests' fields, with no
trained model. Each closure runs on the device of its input. Writing a
synthetic dataset to disk (`make_synthetic_scene`) needs data/provider.py,
ROADMAP A11.
"""

import torch

from nerfnav_tpu_torch.device import device_const
from nerfnav_tpu_torch.models.renderer import Field


def _norm(x):
    return torch.sqrt((x * x).sum(dim=-1))


def sphere_field(radius=0.5, sigma=200.0, bound=1.0):
    """Opaque sphere with position-dependent color (so views differ)."""

    def density_fn(x):
        return torch.where(_norm(x) < radius, sigma, 0.0), x

    def color_fn(d, geo):
        return torch.clamp(geo * 0.8 + 0.6, 0.0, 1.0)

    return Field(density_fn=density_fn, color_fn=color_fn, bound=bound)


def cylinder_field(radius=0.4, sigma=200.0, bound=1.0):
    """Infinite vertical cylinder, the planner's classic obstacle."""

    def density_fn(x):
        return torch.where(_norm(x[:, :2]) < radius, sigma, 0.0), x

    def color_fn(d, geo):
        return torch.full((d.shape[0], 3), 0.7, device=d.device)

    return Field(density_fn=density_fn, color_fn=color_fn, bound=bound)


def textured_sphere_field(radius=0.5, sigma=300.0, bound=1.0):
    """Opaque sphere with a high-frequency color texture: corners for the
    pose filter's feature front end."""

    def density_fn(x):
        d = torch.sqrt((x * x).sum(dim=-1) + 1e-12)
        return sigma * torch.sigmoid((radius - d) * 40.0), x

    def color_fn(d, geo):
        checker = (torch.sin(20.0 * geo[:, 0]) * torch.sin(20.0 * geo[:, 1])
                   * torch.sin(20.0 * geo[:, 2]))
        r = 0.5 + 0.5 * torch.sin(17.0 * geo[:, 0] + 3.0 * geo[:, 1])
        g = 0.5 + 0.5 * checker
        b = 0.5 + 0.5 * torch.cos(13.0 * geo[:, 2])
        return torch.stack([r, g, b], dim=-1)

    return Field(density_fn=density_fn, color_fn=color_fn, bound=bound)


_SPHERES = ((-0.35, -0.30, -0.28, 0.22),  # x, y, z, r
            (0.40, 0.25, -0.30, 0.14),
            (0.05, 0.45, -0.42, 0.08))
_BOXES = ((0.30, -0.40, -0.38, 0.15, 0.10, 0.12),  # cx, cy, cz, hx, hy, hz
          (-0.30, 0.35, -0.44, 0.08, 0.18, 0.06))


def cluttered_field(sigma=300.0, bound=1.0):
    """A textured floor slab, three spheres and two boxes: structure across
    spatial frequencies."""

    def sdf(x):
        ds = [x[:, 2] + 0.55]  # slab below z = -0.55
        for s in _SPHERES:
            c = device_const(s[:3], x.device)
            ds.append(torch.sqrt(((x - c) ** 2).sum(dim=-1) + 1e-12) - s[3])
        for b in _BOXES:
            c, h = device_const(b[:3], x.device), device_const(b[3:], x.device)
            q = (x - c).abs() - h
            outside = torch.sqrt((torch.clamp(q, min=0.0) ** 2).sum(dim=-1) + 1e-12)
            inside = torch.clamp(q.amax(dim=-1), max=0.0)
            ds.append(outside + inside)
        return torch.stack(ds, dim=-1).amin(dim=-1)

    def density_fn(x):
        return sigma * torch.sigmoid(-sdf(x) * 60.0), x

    def color_fn(d, geo):
        hf = torch.sin(25.0 * geo[:, 0]) * torch.sin(25.0 * geo[:, 1])
        r = 0.5 + 0.5 * torch.sin(11.0 * geo[:, 0] + 5.0 * geo[:, 2])
        g = 0.5 + 0.4 * hf + 0.1 * torch.sin(7.0 * geo[:, 1])
        b = 0.5 + 0.5 * torch.cos(9.0 * (geo[:, 1] + geo[:, 2]))
        return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)

    return Field(density_fn=density_fn, color_fn=color_fn, bound=bound)
