"""SO(3)/SE(3) math for the navigation stack.

Counterpart of nerfnav_tpu/nav/math_utils.py: `skew_matrix`, the
Taylor-switched Rodrigues map `vec_to_rot_matrix`, the log map
`rot_matrix_to_vec` with its near-0 and near-pi branches, `mahalanobis`, and
the host numpy helpers `is_pd`, `nearest_pd`, `calc_so3_err`, `calc_se3_err`.

The tensor functions take and return torch tensors on any device and work
under autograd and `torch.func` (jacfwd, vmap): the planner and the pose
filter differentiate through them in both modes. Every `where` keeps its
unused branch finite (a safe operand), so no derivative is NaN at theta = 0.
"""

import numpy as np
import torch

from nerfnav_tpu_torch.models.renderer import _clip


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def skew_matrix(v):
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrices."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def vec_to_rot_matrix(v):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) by Rodrigues,
    R = I + A K + B K^2 with K = skew(v), A = sin(t)/t, B = (1-cos(t))/t^2,
    written in t^2 with Taylor-switched coefficients below t^2 = 1e-8."""
    t2 = (v * v).sum(dim=-1)[..., None, None]
    small = t2 < 1e-8
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2_safe)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2_safe)
    K = skew_matrix(v)
    return _eye3(v).expand(K.shape) + A * K + B * (K @ K)


def _acos_safe(x, eps: float = 1e-7):
    """acos clamped to [-1 + eps, 1 - eps] and continued linearly outside,
    so its derivative stays finite."""
    hi = torch.arccos(torch.full_like(x, 1.0 - eps))
    lo = torch.arccos(torch.full_like(x, -1.0 + eps))
    slope = hi / eps
    buf = _clip(x, -1.0 + eps, 1.0 - eps)
    core = torch.arccos(buf)
    lin_hi = hi - slope * (x - (1.0 - eps))
    lin_lo = lo - slope * (x - (-1.0 + eps))
    return torch.where(x > 1.0 - eps, lin_hi, torch.where(x < -1.0 + eps, lin_lo, core))


def _norm_safe(v, eps: float = 1e-12):
    return torch.sqrt((v * v).sum(dim=-1, keepdim=True) + eps)


def rot_matrix_to_vec(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), the log map.

    Near theta = pi the generic theta / (2 sin theta) form is 0/0; there the
    axis comes from the largest-diagonal column of
    R + R^T - (trace - 1) I = 2 (1 - cos) a a^T, sign-aligned with the
    antisymmetric part."""
    # at least one batch dim: under torch.func.jacfwd, a 0-dim intermediate
    # scaled by a Python float gets a float64 tangent
    lead = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = (trace - 1.0) / 2.0
    theta = _acos_safe(cos_theta)
    off = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_theta = torch.maximum(torch.sin(theta), torch.full_like(theta, 1e-12))
    factor = torch.where(theta < 1e-6, 0.5 + theta**2 / 12.0, theta / (2.0 * sin_theta))
    generic = off * factor[..., None]

    sym = R + R.transpose(-1, -2) - (trace - 1.0)[..., None, None] * _eye3(R).expand(R.shape)
    diag = torch.stack([sym[..., 0, 0], sym[..., 1, 1], sym[..., 2, 2]], dim=-1)
    j = torch.argmax(diag, dim=-1)
    col = torch.gather(sym, -1, j[..., None, None].expand(*sym.shape[:-1], 1))[..., 0]
    axis = col / _norm_safe(col)
    sign = torch.where((col * off).sum(dim=-1) >= 0.0, 1.0, -1.0)
    near_pi = theta[..., None] * sign[..., None] * axis
    return torch.where((cos_theta < -0.99)[..., None], near_pi, generic).reshape(*lead, 3)


def rot_x(theta: float, device="cpu"):
    """Rotation about +x (3, 3) float32."""
    c, s = float(np.cos(theta)), float(np.sin(theta))
    return torch.tensor([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]], device=device)


def mahalanobis(x, mu, sigma):
    """(x - mu)^T Sigma^-1 (x - mu)."""
    d = x - mu
    return d @ torch.linalg.solve(sigma, d)


# ----------------------------------------------------------- host-side numpy
def is_pd(A: np.ndarray) -> bool:
    try:
        np.linalg.cholesky(A)
        return True
    except np.linalg.LinAlgError:
        return False


def nearest_pd(A: np.ndarray) -> np.ndarray:
    """Higham's nearest positive-definite matrix, in float64. NaN and inf
    entries are clamped first, so one bad filter step cannot poison every
    later covariance."""
    A = np.nan_to_num(np.asarray(A, np.float64), nan=0.0, posinf=1e6, neginf=-1e6)
    B = (A + A.T) / 2
    try:
        _, s, V = np.linalg.svd(B)
    except np.linalg.LinAlgError:
        # SVD can fail on ill-conditioned input: clamp the eigenvalues instead
        w, Q = np.linalg.eigh(B)
        return (Q * np.clip(w, 1e-9, None)) @ Q.T
    H = V.T @ np.diag(s) @ V
    A2 = (B + H) / 2
    A3 = (A2 + A2.T) / 2
    if is_pd(A3):
        return A3
    spacing = np.spacing(np.linalg.norm(A))
    eye = np.eye(A.shape[0])
    k = 1
    while not is_pd(A3):
        mineig = np.min(np.real(np.linalg.eigvals(A3)))
        A3 += eye * (-mineig * k**2 + spacing)
        k += 1
    return A3


def calc_so3_err(R1, R2):
    """Geodesic rotation error in degrees."""
    R1, R2 = np.asarray(R1), np.asarray(R2)
    rel = R1 @ R2.T
    cos = np.clip((np.trace(rel) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos)))


def calc_se3_err(pose, pose_gt):
    """(rot_err_deg, trans_err) between two 4x4 (or 3x4) poses."""
    pose, pose_gt = np.asarray(pose), np.asarray(pose_gt)
    rot_err = calc_so3_err(pose[:3, :3], pose_gt[:3, :3])
    trans_err = float(np.linalg.norm(pose[:3, 3] - pose_gt[:3, 3]))
    return rot_err, trans_err
