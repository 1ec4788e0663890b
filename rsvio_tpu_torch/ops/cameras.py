"""Camera models: pinhole-radtan (OpenCV 5-coefficient) on batched tensors.

Port of rsvio_tpu/ops/cameras.py for the stereo VO main path. Parameters use
the same fixed-width packing, so a stereo pair is one (2, 10) tensor:
  pinhole-radtan: [fx, fy, cx, cy, k1, k2, p1, p2, k3, 0]
Points are batched: ``p_cam`` is (..., 3), ``uv`` is (..., 2); ``params`` is
(10,) or broadcastable (..., 10).

EUCM is not ported yet (ROADMAP A3); asking for it raises.
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


def unproject(kind: str, params, uv):
    """Pixels -> normalized coords for camera model `kind`."""
    if kind.lower() == EUCM:
        raise NotImplementedError(
            "EUCM camera model is not ported yet (ROADMAP A3)")
    return radtan_unproject(params, uv)
