"""Lie-group math on batched tensors: SO(3) and SE(3).

Port of the parts of rsvio_tpu/ops/lie.py that the stereo VO main path
calls. The JAX functions are written for one element and vmapped; here every
function takes leading batch dimensions: ``w`` is (..., 3), ``R`` (..., 3, 3),
``T`` (..., 4, 4). Small-angle branches stay branchless (``torch.where`` on
safe operands), with the same Taylor coefficients and threshold.

SE(2) has ``se2_exp``, for the gather KLT path's patch warps. Quaternions
and ``se2_log`` are not ported yet.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _where_small(theta_sq, taylor, exact):
    """Branchless select of a Taylor expansion for small angles."""
    return torch.where(theta_sq < _EPS, taylor, exact)


def _safe(theta_sq):
    """theta_sq with 1.0 inside the Taylor region, so the unused exact
    branch never divides by ~0."""
    return torch.where(theta_sq < _EPS, torch.ones_like(theta_sq), theta_sq)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def so3_hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric [w]x."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def so3_exp(w):
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta_sq = (w * w).sum(-1)
    ts = _safe(theta_sq)
    theta = torch.sqrt(ts)
    W = so3_hat(w)
    a = _where_small(theta_sq, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = _where_small(theta_sq, 0.5 - theta_sq / 24.0,
                     (1.0 - torch.cos(theta)) / ts)
    return (_eye(3, w) + a[..., None, None] * W
            + b[..., None, None] * (W @ W))


def so3_log(R):
    """(..., 3, 3) rotation -> (..., 3) axis-angle; safe near 0, valid
    below pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    theta_sq = theta * theta
    sin_safe = torch.where(theta_sq < _EPS, torch.ones_like(theta),
                           torch.sin(theta))
    factor = _where_small(theta_sq, 0.5 + theta_sq / 12.0,
                          theta / (2.0 * sin_safe))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    return factor[..., None] * v


def so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3); se3_exp's translation is J_l(w) v."""
    theta_sq = (w * w).sum(-1)
    ts = _safe(theta_sq)
    theta = torch.sqrt(ts)
    W = so3_hat(w)
    b = _where_small(theta_sq, 0.5 - theta_sq / 24.0,
                     (1.0 - torch.cos(theta)) / ts)
    c = _where_small(theta_sq, 1.0 / 6.0 - theta_sq / 120.0,
                     (theta - torch.sin(theta)) / (ts * theta))
    return (_eye(3, w) + b[..., None, None] * W
            + c[..., None, None] * (W @ W))


def se3_from_rt(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = _eye(4, R).expand(*batch, 4, 4).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def se3_inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3_from_rt(Rt, -(Rt @ t[..., None])[..., 0])


def se3_exp(xi):
    """(..., 6) tangent [v, w] -> (..., 4, 4); t = J_l(w) v."""
    v, w = xi[..., :3], xi[..., 3:]
    return se3_from_rt(so3_exp(w),
                       (so3_left_jacobian(w) @ v[..., None])[..., 0])


def se3_retract_split(T, delta):
    """Split retraction used by the solvers: t += dt; R <- R @ exp(dw)."""
    R = T[..., :3, :3] @ so3_exp(delta[..., 3:])
    t = T[..., :3, 3] + delta[..., :3]
    return se3_from_rt(R, t)


def rotation_angle(R):
    """Geodesic rotation angle in radians."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))


# ---------------------------------------------------------------------------
# SE(2) — KLT patch warps. Tangent [tx, ty, theta] -> 3x3 affine matrix.
# ---------------------------------------------------------------------------

def se2_exp(xi):
    """(..., 3) tangent [tx, ty, theta] -> (..., 3, 3), with the small-angle
    Taylor branch of the V matrix (a = sin(t)/t, b = (1-cos(t))/t)."""
    tx, ty, theta = xi[..., 0], xi[..., 1], xi[..., 2]
    theta_sq = theta * theta
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    t_safe = torch.where(theta_sq < _EPS, torch.ones_like(theta), theta)
    a = _where_small(theta_sq, 1.0 - theta_sq / 6.0, sin_t / t_safe)
    b = _where_small(theta_sq, theta / 2.0 - theta_sq * theta / 24.0,
                     (1.0 - cos_t) / t_safe)
    x = a * tx - b * ty
    y = b * tx + a * ty
    one = torch.ones_like(tx)
    zero = torch.zeros_like(tx)
    return torch.stack([
        torch.stack([cos_t, -sin_t, x], dim=-1),
        torch.stack([sin_t, cos_t, y], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
