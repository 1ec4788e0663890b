"""Image pyramid: separable [1,2,1]/4 filter + stride 2, edge padding,
floor level sizes.

Port of rsvio_tpu/ops/pyramid.py (``build_pyramid_ratio`` waits, ROADMAP
A15). Images are (H, W) float tensors; a pyramid is a tuple of levels.
"""

from __future__ import annotations

from typing import Sequence

import torch


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


def pyramid_shapes(shape, levels: int) -> Sequence[tuple]:
    """Static level shapes for a base shape."""
    H, W = shape
    shapes = []
    for _ in range(levels):
        shapes.append((H, W))
        H, W = H // 2, W // 2
    return shapes
