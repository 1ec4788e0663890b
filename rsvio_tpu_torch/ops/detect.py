"""Feature detection: whole-image FAST-9 and Shi-Tomasi scores, grid-cell
selection and block non-max suppression.

Port of rsvio_tpu/ops/detect.py.

Integer semantics follow the reference exactly: float floor division is
``torch.div(..., rounding_mode="floor")``, float->int conversion truncates
toward zero like ``.astype(int32)``, ``torch.round`` rounds half to even like
``jnp.round`` and ``torch.argmax`` returns the first maximum like
``jnp.argmax``. ``nms_select`` ranks its peaks by (score descending, linear
index ascending) with a stable sort: the order ``lax.top_k`` gives on ties,
which ``torch.topk`` does not promise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (16 ring offsets, (dy, dx)), clockwise from
# the top.
_FAST_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shift2(img, dy: int, dx: int):
    """out[y, x] = img[y + dy, x + dx], zero outside the image."""
    H, W = img.shape
    out = torch.zeros_like(img)
    ys = slice(max(0, dy), H + min(0, dy))
    yd = slice(max(0, -dy), H + min(0, -dy))
    xs = slice(max(0, dx), W + min(0, dx))
    xd = slice(max(0, -dx), W + min(0, -dx))
    out[yd, xd] = img[ys, xs]
    return out


def fast_score(img):
    """FAST-9 margin score per pixel: max over the 16 arc starts of the min
    margin over a 9-long contiguous ring arc, max of both polarities; zero
    within 3 px of the border."""
    diffs = torch.stack([_shift2(img, dy, dx) - img
                         for (dy, dx) in _FAST_RING])      # (16, H, W)

    def run_score(m):
        ext = torch.cat([m, m[:8]], dim=0)                 # (24, H, W)
        best = torch.full_like(m[0], -torch.inf)
        for s in range(16):
            run = ext[s]
            for k in range(1, 9):
                run = torch.minimum(run, ext[s + k])
            best = torch.maximum(best, run)
        return best

    score = torch.maximum(run_score(diffs), run_score(-diffs))
    H, W = img.shape
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return torch.where(interior, score, torch.zeros_like(score))


def _box3(img):
    """3x3 box filter, edge-replicated."""
    up = torch.cat([img[:1], img[:-1]], dim=0)
    dn = torch.cat([img[1:], img[-1:]], dim=0)
    v = up + img + dn
    lf = torch.cat([v[:, :1], v[:, :-1]], dim=1)
    rt = torch.cat([v[:, 1:], v[:, -1:]], dim=1)
    return (lf + v + rt) / 9.0


def shi_tomasi_score(img):
    """Min-eigenvalue (Shi-Tomasi) score per pixel: central-difference
    gradients (zero outside the image), 3x3 box-smoothed structure tensor,
    0.5 (trace - sqrt(trace^2 - 4 det))."""
    gx = (_shift2(img, 0, 1) - _shift2(img, 0, -1)) * 0.5
    gy = (_shift2(img, 1, 0) - _shift2(img, -1, 0)) * 0.5
    ixx = _box3(gx * gx)
    iyy = _box3(gy * gy)
    ixy = _box3(gx * gy)
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    return 0.5 * (tr - disc)


def _max_pool(x, k: int):
    """Max over the k x k window centered on each pixel, -inf outside
    (reduce_window max with SAME padding)."""
    return F.max_pool2d(x[None, None], k, stride=1, padding=k // 2)[0, 0]


def nms_select(score, occupied_xy, occupied_mask, radius: int,
               margin: int = 19, min_score: float = 10.0, max_new: int = 128):
    """Block non-max suppression with min-distance suppression against live
    tracks.

    A pixel is a peak if it is the maximum of its (2 radius + 1)^2 window,
    above min_score, inside the border margin and not at a live track;
    live tracks enter the window maxima as the largest float, so no peak
    lies within `radius` of one. Ties inside a window keep the lowest linear
    index. Returns (cand_xy (max_new, 2) float (x, y), cand_ok (max_new,)),
    score-descending.
    """
    H, W = score.shape
    dev = score.device
    big = torch.finfo(score.dtype).max
    occ_x = torch.clamp(torch.round(occupied_xy[:, 0]).to(torch.int64),
                        0, W - 1)
    occ_y = torch.clamp(torch.round(occupied_xy[:, 1]).to(torch.int64),
                        0, H - 1)
    inject = torch.zeros(H * W, dtype=score.dtype, device=dev).scatter_reduce(
        0, occ_y * W + occ_x,
        torch.where(occupied_mask, big, 0.0).to(score.dtype),
        reduce="amax").reshape(H, W)
    k = 2 * radius + 1
    pooled = _max_pool(torch.maximum(score, inject), k)

    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    in_border = ((yy >= margin) & (yy < H - margin)
                 & (xx >= margin) & (xx < W - margin))
    pre_peak = ((score >= pooled) & (score > min_score) & in_border
                & (inject <= 0))
    neg_inf = torch.full_like(score, -torch.inf)
    lin = yy * W + xx
    neg_idx = torch.where(pre_peak, (-lin).to(score.dtype), neg_inf)
    is_peak = pre_peak & (neg_idx >= _max_pool(neg_idx, k))

    flat = torch.where(is_peak, score, neg_inf).reshape(-1)
    vals, idx = torch.sort(flat, descending=True, stable=True)
    vals, idx = vals[:max_new], idx[:max_new]
    cand_xy = torch.stack([(idx % W).to(score.dtype),
                           (idx // W).to(score.dtype)], dim=1)
    return cand_xy, vals > -torch.inf


def select_grid_features(score, occupied_xy, occupied_mask, cell_size: int,
                         margin: int = 19, min_score: float = 10.0,
                         max_per_cell: int = 1, min_dist: int = 5,
                         cell_occupancy: bool = True):
    """Top-scoring pixel(s) of every grid cell that holds no live track.

    score (H, W); occupied_xy (N, 2) live positions (x, y); occupied_mask
    (N,) bool. Returns (cand_xy (C*max_per_cell, 2) float, cand_ok (C*k,)
    bool), grouped by pick round, cells in row-major order.
    cell_occupancy=False is the starvation form: instead of closing its
    whole cell, a live track suppresses the (2 min_dist + 1)^2 box of score
    pixels around its rounded position.
    """
    H, W = score.shape
    dev = score.device
    gh, gw = H // cell_size, W // cell_size
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    in_border = ((yy >= margin) & (yy < H - margin)
                 & (xx >= margin) & (xx < W - margin))
    s = torch.where(in_border, score, torch.full_like(score, -torch.inf))
    if cell_occupancy:
        occ_col = torch.clamp(torch.div(occupied_xy[:, 0], cell_size,
                                        rounding_mode="floor").to(torch.int32),
                              0, gw - 1)
        occ_row = torch.clamp(torch.div(occupied_xy[:, 1], cell_size,
                                        rounding_mode="floor").to(torch.int32),
                              0, gh - 1)
        occ_idx = (occ_row * gw + occ_col).to(torch.int64)
        occ = torch.zeros(gh * gw, dtype=torch.int32,
                          device=dev).scatter_reduce(
            0, occ_idx, occupied_mask.to(torch.int32), reduce="amax") > 0
    else:
        occ_x = torch.clamp(torch.round(occupied_xy[:, 0]).to(torch.int64),
                            0, W - 1)
        occ_y = torch.clamp(torch.round(occupied_xy[:, 1]).to(torch.int64),
                            0, H - 1)
        hit = torch.zeros(H * W, dtype=score.dtype, device=dev).scatter_reduce(
            0, occ_y * W + occ_x, occupied_mask.to(score.dtype),
            reduce="amax").reshape(H, W)
        near = _max_pool(hit, 2 * min_dist + 1) > 0
        s = torch.where(near, torch.full_like(s, -torch.inf), s)
        occ = torch.zeros(gh * gw, dtype=torch.bool, device=dev)
    s = s[: gh * cell_size, : gw * cell_size]
    cells = (s.reshape(gh, cell_size, gw, cell_size).permute(0, 2, 1, 3)
             .reshape(gh * gw, cell_size, cell_size))

    cell = torch.arange(gh * gw, dtype=torch.int32, device=dev)
    cell_row, cell_col = cell // gw, cell % gw
    iy = torch.arange(cell_size, device=dev)[:, None]
    ix = torch.arange(cell_size, device=dev)[None, :]
    xy_all, ok_all = [], []
    for _ in range(max_per_cell):
        flat = cells.reshape(gh * gw, cell_size * cell_size)
        best = torch.argmax(flat, dim=1).to(torch.int32)
        best_score = torch.gather(flat, 1, best[:, None].to(torch.int64))[:, 0]
        cy = best // cell_size
        cx = best % cell_size
        cand_y = cell_row * cell_size + cy
        cand_x = cell_col * cell_size + cx
        xy_all.append(torch.stack([cand_x, cand_y], dim=1).to(score.dtype))
        ok_all.append((best_score > min_score) & (~occ))
        if max_per_cell > 1:
            near = ((torch.abs(iy[None] - cy[:, None, None]) <= min_dist)
                    & (torch.abs(ix[None] - cx[:, None, None]) <= min_dist))
            cells = torch.where(near, torch.full_like(cells, -torch.inf),
                                cells)
    return torch.cat(xy_all, dim=0), torch.cat(ok_all, dim=0)
