"""Image pyramid: separable [1,2,1]/4 filter + stride 2, edge padding,
floor level sizes.

Port of rsvio_tpu/ops/pyramid.py. Images are (H, W) float tensors; a
pyramid is a tuple of levels. ``build_pyramid_ratio`` makes arbitrary-ratio
pyramids with an optional pre-blur.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def downsample2(img):
    """One /2 level: out[j] = (in[2j-1] + 2 in[2j] + in[2j+1]) / 4 along each
    axis, edge-replicated at the borders."""
    H, W = img.shape
    H2, W2 = H // 2, W // 2
    img = img[: H2 * 2, : W2 * 2]
    left = torch.cat([img[:, :1], img[:, :-1]], dim=1)
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    h = (left + 2.0 * img + right)[:, ::2] * 0.25
    up = torch.cat([h[:1, :], h[:-1, :]], dim=0)
    down = torch.cat([h[1:, :], h[-1:, :]], dim=0)
    return (up + 2.0 * h + down)[::2, :] * 0.25


def build_pyramid(img, levels: int):
    """`levels` levels, level 0 = full resolution; shapes (H/2^i, W/2^i)."""
    out = [img]
    for _ in range(levels - 1):
        out.append(downsample2(out[-1]))
    return tuple(out)


def gaussian_blur3(img):
    """Separable [1,2,1]/4 blur, edge-replicated, same shape."""
    left = torch.cat([img[:, :1], img[:, :-1]], dim=1)
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    h = (left + 2.0 * img + right) * 0.25
    up = torch.cat([h[:1, :], h[:-1, :]], dim=0)
    down = torch.cat([h[1:, :], h[-1:, :]], dim=0)
    return (up + 2.0 * h + down) * 0.25


def build_pyramid_ratio(img, levels: int, ratio: float, blur: bool = False,
                        blur_sigma: float = 0.7):
    """Arbitrary-ratio pyramid: level i has shape round(shape * ratio^i)
    (at least 1) and is a linear resize of level i-1, optionally blurred
    first by n = round(2 sigma^2) passes of ``gaussian_blur3`` (at least
    one).

    The resize is the triangle filter of ``jax.image.resize(method=
    "linear")``: on downsampling its support widens by 1/scale
    (antialiasing), and weights falling outside the image are dropped and
    the rest renormalized — what ``F.interpolate(mode="bilinear",
    antialias=True, align_corners=False)`` computes.
    """
    n_pass = max(1, int(round(2.0 * blur_sigma * blur_sigma)))
    out = [img]
    H, W = img.shape
    for i in range(1, levels):
        h = max(int(round(H * ratio ** i)), 1)
        w = max(int(round(W * ratio ** i)), 1)
        src = out[-1]
        if blur:
            for _ in range(n_pass):
                src = gaussian_blur3(src)
        out.append(F.interpolate(src[None, None], size=(h, w),
                                 mode="bilinear", antialias=True,
                                 align_corners=False)[0, 0])
    return tuple(out)


def pyramid_shapes(shape, levels: int) -> Sequence[tuple]:
    """Static level shapes for a base shape."""
    H, W = shape
    shapes = []
    for _ in range(levels):
        shapes.append((H, W))
        H, W = H // 2, W // 2
    return shapes
