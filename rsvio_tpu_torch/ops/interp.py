"""Image sampling: bilinear / Catmull-Rom bicubic interpolation with
gradients, and the in-image test.

Port of rsvio_tpu/ops/interp.py. The JAX functions sample one point and are
vmapped; here ``xy`` is (..., 2) and every result has its leading shape.
Images are (H, W); integer coordinates are pixel centers. Taps outside the
image read the nearest edge pixel, and every sampler returns a validity mask
(``x``, ``y`` at least 0 or 1 px inside, as in JAX) instead of failing.
"""

from __future__ import annotations

import torch


def _floor_index(v, n: int):
    """(floor(v) as int64 clamped to [-4, n + 4], frac). The clamp leaves
    every edge-clamped tap unchanged and keeps NaN or huge coordinates
    (whose samples are invalid) from overflowing the index."""
    fl = torch.floor(v)
    idx = torch.clamp(torch.nan_to_num(fl), -4.0, n + 4.0).to(torch.int64)
    return idx, v - fl


def _gather2(img, yi, xi):
    """img[yi, xi] with indices clamped into the image."""
    H, W = img.shape
    return img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]


def bilinear(img, xy):
    """Bilinear sample at (x, y). Returns (value, valid)."""
    H, W = img.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, fx = _floor_index(x, W)
    y0, fy = _floor_index(y, H)
    v00 = _gather2(img, y0, x0)
    v01 = _gather2(img, y0, x0 + 1)
    v10 = _gather2(img, y0 + 1, x0)
    v11 = _gather2(img, y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    val = top * (1 - fy) + bot * fy
    valid = (x >= 0) & (y >= 0) & (x <= W - 1.001) & (y <= H - 1.001)
    return val, valid


def bilinear_with_grad(img, xy):
    """Bilinear sample + central-difference gradient from half-pixel
    bilinear samples. Returns (value, grad (..., 2), valid)."""
    x, y = xy[..., 0], xy[..., 1]
    v, ok0 = bilinear(img, xy)
    vxp, ok1 = bilinear(img, torch.stack([x + 0.5, y], dim=-1))
    vxm, ok2 = bilinear(img, torch.stack([x - 0.5, y], dim=-1))
    vyp, ok3 = bilinear(img, torch.stack([x, y + 0.5], dim=-1))
    vym, ok4 = bilinear(img, torch.stack([x, y - 0.5], dim=-1))
    valid = ok0 & ok1 & ok2 & ok3 & ok4
    return v, torch.stack([vxp - vxm, vyp - vym], dim=-1), valid


def _cubic_weights(t):
    """Catmull-Rom weights for the taps at offsets [-1, 0, 1, 2]."""
    t2 = t * t
    t3 = t2 * t
    return (-0.5 * t3 + t2 - 0.5 * t,
            1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t,
            0.5 * t3 - 0.5 * t2)


def _cubic_weights_d(t):
    """Derivatives of the Catmull-Rom weights with respect to t."""
    t2 = t * t
    return (-1.5 * t2 + 2.0 * t - 0.5,
            4.5 * t2 - 5.0 * t,
            -4.5 * t2 + 4.0 * t + 0.5,
            1.5 * t2 - t)


def _bicubic_valid(img, x, y):
    H, W = img.shape
    return (x >= 1) & (y >= 1) & (x <= W - 2.001) & (y <= H - 2.001)


def bicubic(img, xy):
    """Catmull-Rom bicubic sample at (x, y). Returns (value, valid)."""
    H, W = img.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, tx = _floor_index(x, W)
    y0, ty = _floor_index(y, H)
    wx, wy = _cubic_weights(tx), _cubic_weights(ty)
    acc = torch.zeros_like(x)
    for j in range(4):
        row = torch.zeros_like(x)
        for i in range(4):
            row = row + wx[i] * _gather2(img, y0 + j - 1, x0 + i - 1)
        acc = acc + wy[j] * row
    return acc, _bicubic_valid(img, x, y)


def bicubic_with_grad(img, xy):
    """Bicubic sample + analytic gradient (d/dx, d/dy). Returns (value,
    grad (..., 2), valid)."""
    H, W = img.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, tx = _floor_index(x, W)
    y0, ty = _floor_index(y, H)
    wx, dwx = _cubic_weights(tx), _cubic_weights_d(tx)
    wy, dwy = _cubic_weights(ty), _cubic_weights_d(ty)
    val = torch.zeros_like(x)
    gx = torch.zeros_like(x)
    gy = torch.zeros_like(x)
    for j in range(4):
        taps = [_gather2(img, y0 + j - 1, x0 + i - 1) for i in range(4)]
        row = torch.zeros_like(x)
        for i in range(4):
            row = row + wx[i] * taps[i]
        drow = torch.zeros_like(x)
        for i in range(4):
            drow = drow + dwx[i] * taps[i]
        val = val + wy[j] * row
        gx = gx + wy[j] * drow
        gy = gy + dwy[j] * row
    return val, torch.stack([gx, gy], dim=-1), _bicubic_valid(img, x, y)


def in_bounds(xy, shape, margin: float = 0.0):
    """Point-in-image test with margin, over (..., 2) points."""
    H, W = shape
    x, y = xy[..., 0], xy[..., 1]
    return ((x >= margin) & (y >= margin) & (x <= W - 1 - margin)
            & (y <= H - 1 - margin))
