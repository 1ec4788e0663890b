"""Lie-group math on batched tensors: SO(3), quaternions, SE(3), SE(2).

Port of rsvio_tpu/ops/lie.py. The JAX functions are written for one element
and vmapped; here every function takes leading batch dimensions: ``w`` is
(..., 3), ``R`` (..., 3, 3), ``q`` (..., 4) in (w, x, y, z) order, ``T``
(..., 4, 4). Small-angle branches stay branchless (``torch.where`` on safe
operands), with the same Taylor coefficients and threshold.
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


def so3_vee(W):
    """Inverse of so3_hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


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


# ---------------------------------------------------------------------------
# Quaternions, (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_normalize(q):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_to_rot(q):
    """Unit quaternion (..., 4) -> (..., 3, 3) rotation."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def rot_to_quat(R):
    """(..., 3, 3) rotation -> unit quaternion (..., 4), w >= 0. Shepperd's
    four candidates, each good in one regime (the trace, or the largest
    diagonal entry), chosen by torch.where as in JAX."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = m
    tr = m00 + m11 + m22

    def half_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 0.5

    qw = half_sqrt(1.0 + tr)
    q0 = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                      (m10 - m01) / (4 * qw)], dim=-1)
    qx = half_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                      (m02 + m20) / (4 * qx)], dim=-1)
    qy = half_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                      (m12 + m21) / (4 * qy)], dim=-1)
    qz = half_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                      (m12 + m21) / (4 * qz), qz], dim=-1)
    cond_tr = (tr > 0)[..., None]
    cond_x = ((m00 > m11) & (m00 > m22))[..., None]
    cond_y = (m11 > m22)[..., None]
    q = torch.where(cond_tr, q0,
                    torch.where(cond_x, q1, torch.where(cond_y, q2, q3)))
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


# ---------------------------------------------------------------------------
# SE(3) — 4x4 homogeneous matrices; tangent ordering [v (trans), w (rot)]
# ---------------------------------------------------------------------------

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


def se3_log(T):
    """(..., 4, 4) -> (..., 6) tangent [v, w]: v solves J_l(w) v = t."""
    w = so3_log(T[..., :3, :3])
    v = torch.linalg.solve(so3_left_jacobian(w), T[..., :3, 3:])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_mul(Ta, Tb):
    return Ta @ Tb


def se3_apply(T, p):
    """Apply (..., 4, 4) to the 3-points (..., 3)."""
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]


def se3_retract_split(T, delta):
    """Split retraction used by the solvers: t += dt; R <- R @ exp(dw)."""
    R = T[..., :3, :3] @ so3_exp(delta[..., 3:])
    t = T[..., :3, 3] + delta[..., :3]
    return se3_from_rt(R, t)


def se3_to_packed(T):
    """(..., 4, 4) -> [tx ty tz qw qx qy qz] (..., 7), the reference
    solver's layout."""
    return torch.cat([T[..., :3, 3], rot_to_quat(T[..., :3, :3])], dim=-1)


def se3_from_packed(p7):
    return se3_from_rt(quat_to_rot(quat_normalize(p7[..., 3:])), p7[..., :3])


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


def se2_log(M):
    """(..., 3, 3) SE(2) affine -> [tx, ty, theta] (..., 3)."""
    theta = torch.atan2(M[..., 1, 0], M[..., 0, 0])
    theta_sq = theta * theta
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    t_safe = torch.where(theta_sq < _EPS, torch.ones_like(theta), theta)
    a = _where_small(theta_sq, 1.0 - theta_sq / 6.0, sin_t / t_safe)
    b = _where_small(theta_sq, theta / 2.0, (1.0 - cos_t) / t_safe)
    det = a * a + b * b
    x, y = M[..., 0, 2], M[..., 1, 2]
    return torch.stack([(a * x + b * y) / det, (-b * x + a * y) / det,
                        theta], dim=-1)
