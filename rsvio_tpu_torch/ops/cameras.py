"""Camera models: pinhole-radtan (OpenCV 5-coefficient) and EUCM on batched
tensors.

Port of rsvio_tpu/ops/cameras.py. Parameters use the same fixed-width
packing, so a stereo pair is one (2, 10) tensor:
  pinhole-radtan: [fx, fy, cx, cy, k1, k2, p1, p2, k3, 0]
  EUCM:           [fx, fy, cx, cy, alpha, beta, 0, 0, 0, 0]
Points are batched: ``p_cam`` is (..., 3), ``uv`` is (..., 2); ``params`` is
(10,) or broadcastable (..., 10). The model kind is a string, matched
without case; an unknown kind raises (the JAX package takes any kind other
than EUCM as pinhole-radtan).
"""

from __future__ import annotations

import torch

PINHOLE_RADTAN = "pinhole-radtan"
EUCM = "eucm"

PARAM_WIDTH = 10

# Fixed-point radtan undistortion iterations (same count as the reference).
_UNDISTORT_ITERS = 8


def pack_params(kind: str, intrinsics, distortion, dtype=torch.float32,
                device="cuda"):
    """(PARAM_WIDTH,) parameter vector from config-style lists; missing
    distortion entries default to 0 (EUCM: alpha 0.5, beta 1.0)."""
    kind = kind.lower()
    p = [0.0] * PARAM_WIDTH
    p[:4] = [float(v) for v in intrinsics[:4]]
    d = [float(v) for v in distortion]
    if kind == EUCM:
        p[4] = d[0] if len(d) > 0 else 0.5
        p[5] = d[1] if len(d) > 1 else 1.0
    else:
        for i in range(min(5, len(d))):
            p[4 + i] = d[i]
    return torch.tensor(p, dtype=dtype, device=device)


def _coeffs(params):
    return tuple(params[..., i] for i in range(9))


def _radtan_distort(params, xy):
    _, _, _, _, k1, k2, p1, p2, k3 = _coeffs(params)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def radtan_project(params, p_cam):
    """(..., 3) camera-frame points -> ((..., 2) pixels, (...) valid z>0)."""
    fx, fy, cx, cy = _coeffs(params)[:4]
    z = p_cam[..., 2]
    valid = z > 1e-6
    z_safe = torch.where(valid, z, torch.ones_like(z))
    xy = torch.stack([p_cam[..., 0] / z_safe, p_cam[..., 1] / z_safe], dim=-1)
    xd = _radtan_distort(params, xy)
    uv = torch.stack([fx * xd[..., 0] + cx, fy * xd[..., 1] + cy], dim=-1)
    return uv, valid


def radtan_unproject(params, uv):
    """(..., 2) pixels -> (..., 2) normalized coords at z=1 by fixed-point
    undistortion, x_{n+1} = (x_dist - tangential(x_n)) / radial(x_n)."""
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = _coeffs(params)
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(_UNDISTORT_ITERS):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x, y], dim=-1)


def eucm_project(params, p_cam):
    """EUCM projection: d = sqrt(beta (x^2 + y^2) + z^2), den = alpha d +
    (1 - alpha) z. valid needs den > 0 and z > -w d with w = alpha /
    (1 - alpha) for alpha <= 0.5, else (1 - alpha) / alpha."""
    fx, fy, cx, cy, alpha, beta = _coeffs(params)[:6]
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    d = torch.sqrt(beta * (x * x + y * y) + z * z)
    den = alpha * d + (1.0 - alpha) * z
    w = torch.where(alpha <= 0.5, alpha / torch.clamp(1.0 - alpha, min=1e-6),
                    (1.0 - alpha) / torch.clamp(alpha, min=1e-6))
    valid = (den > 1e-6) & (z > -w * d)
    den_safe = torch.where(den > 1e-6, den, torch.ones_like(den))
    uv = torch.stack([fx * x / den_safe + cx, fy * y / den_safe + cy], dim=-1)
    return uv, valid


def eucm_unproject(params, uv):
    """Closed-form EUCM unprojection -> normalized coords at z=1. Beyond
    the model's 90-degree ray mz is negative and the result is the
    opposite ray's normalized coordinates, as in the JAX package."""
    fx, fy, cx, cy, alpha, beta = _coeffs(params)[:6]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r2 = mx * mx + my * my
    gamma = 1.0 - alpha
    inner = torch.clamp(1.0 - (2.0 * alpha - 1.0) * beta * r2, min=1e-9)
    mz = (1.0 - beta * alpha * alpha * r2) / (alpha * torch.sqrt(inner)
                                              + gamma)
    mz_safe = torch.where(torch.abs(mz) > 1e-9, mz, torch.full_like(mz, 1e-9))
    return torch.stack([mx / mz_safe, my / mz_safe], dim=-1)


def _is_eucm(kind: str) -> bool:
    k = kind.lower()
    if k not in (PINHOLE_RADTAN, EUCM):
        raise ValueError(f"unknown camera model {kind!r}")
    return k == EUCM


def project(kind: str, params, p_cam):
    """(..., 3) camera-frame points -> ((..., 2) pixels, (...) valid) for
    camera model `kind`."""
    if _is_eucm(kind):
        return eucm_project(params, p_cam)
    return radtan_project(params, p_cam)


def unproject(kind: str, params, uv):
    """Pixels -> normalized coords for camera model `kind`."""
    if _is_eucm(kind):
        return eucm_unproject(params, uv)
    return radtan_unproject(params, uv)


def project_normalized(p_cam):
    """Pure pinhole normalization (x/z, y/z) with cheirality validity, the
    projection inside the optimizer (ref src/optimization/factors.rs:136).
    p_cam (..., 3) -> (xy (..., 2), valid (...)): valid where z > 1e-6; z
    taken as 1 where not."""
    z = p_cam[..., 2]
    valid = z > 1e-6
    z_safe = torch.where(valid, z, torch.ones_like(z))
    return torch.stack([p_cam[..., 0] / z_safe, p_cam[..., 1] / z_safe],
                       dim=-1), valid
