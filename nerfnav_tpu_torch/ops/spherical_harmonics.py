"""Real spherical-harmonics view-direction encoding, degree 1..8.

Counterpart of nerfnav_tpu/ops/spherical_harmonics.py: the basis is built
from the associated-Legendre recurrences (orthonormal real SH with the
Condon-Shortley phase), in the same order and with the same constants."""

import math

import torch


def sh_output_dim(degree: int) -> int:
    return degree * degree


def _double_factorial(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def _K(l: int, m: int) -> float:
    """Orthonormalization constant sqrt((2l+1)/(4pi) * (l-m)!/(l+m)!)."""
    num = (2 * l + 1) * math.factorial(l - m)
    den = 4.0 * math.pi * math.factorial(l + m)
    return math.sqrt(num / den)


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """d: (..., 3) unit direction -> (..., degree**2) real-SH basis values."""
    if not 1 <= degree <= 8:
        raise ValueError(f"sh_encode supports degree 1..8, got {degree}")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    one = torch.ones_like(z)

    # A_m = Re((x+iy)^m), B_m = Im((x+iy)^m)
    A = [one]
    B = [torch.zeros_like(z)]
    for m in range(1, degree):
        A.append(x * A[m - 1] - y * B[m - 1])
        B.append(x * B[m - 1] + y * A[m - 1])

    # Q[l][m] = P_l^m(z) / sin^m(theta)
    Q = {}
    for m in range(degree):
        Q[(m, m)] = ((-1.0) ** m) * _double_factorial(2 * m - 1) * one
        if m + 1 < degree:
            Q[(m + 1, m)] = z * (2 * m + 1) * Q[(m, m)]
        for l in range(m + 2, degree):
            Q[(l, m)] = ((2 * l - 1) * z * Q[(l - 1, m)]
                         - (l + m - 1) * Q[(l - 2, m)]) / (l - m)

    comps = []
    sqrt2 = math.sqrt(2.0)
    for l in range(degree):
        for m in range(-l, l + 1):
            am = abs(m)
            if m == 0:
                comps.append(_K(l, 0) * Q[(l, 0)])
            elif m > 0:
                comps.append(sqrt2 * _K(l, am) * Q[(l, am)] * A[am])
            else:
                comps.append(sqrt2 * _K(l, am) * Q[(l, am)] * B[am])
    return torch.stack(comps, dim=-1)
