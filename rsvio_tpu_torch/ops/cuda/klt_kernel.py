"""Fused bidirectional pyramid KLT: the hand-written Hopper kernel, its
wrapper, and its plain PyTorch version.

Counterpart of rsvio_tpu/ops/pallas/klt_kernel.py. The kernel
(``csrc/klt_bidir.cu``) replaces the TPU kernel ``track_bidirectional_pyramid``
/ ``_klt_bidir_kernel`` there: one launch tracks every feature forward over
all pyramid levels (coarse to fine), backward from the forward result, and
applies the return-distance gate. The per-level body is the TPU kernel's
``_level_pass``: a dense 16x16 unit-spacing patch, bilinear samples and
bilinearly interpolated central-difference gradients, LSSD (or SSD)
residuals, a 2x2 Gauss-Newton system plus fixed Levenberg damping, per-feature
freeze on convergence or failure.

Images come as one packed (C, sum_l H_l*W_l) float32 buffer per pyramid
(``pack_pyramids``): level l of camera c is ``buf[c, off_l:off_l+H_l*W_l]``
viewed as (H_l, W_l). Positions are full-resolution pixels (x, y).

Routing: a CUDA tensor always goes to the kernel, a CPU tensor to
``klt_bidir_reference``. There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

PATCH = 16
WIN = 20          # 16x16 pattern + bilinear taps + gradient ring
CENTER = 9        # window index of floor(position)
MARGIN = 2.0      # center-validity margin in px
MAX_LEVELS = 8
_MIN_GRAD_ENERGY = 1e-4
_MIN_GRAD_ENERGY_SSD = 1e-4 * 255.0 ** 2
_MIN_MEAN = 1e-3
_DET_EPS = 1e-12


def pack_pyramids(pyrs):
    """Sequence of C pyramids (tuples of (H_l, W_l) levels, same shapes) ->
    ((C, T) contiguous buffer, dims tuple of (H_l, W_l))."""
    dims = tuple(tuple(lvl.shape) for lvl in pyrs[0])
    buf = torch.stack([torch.cat([lvl.reshape(-1) for lvl in pyr])
                       for pyr in pyrs])
    return buf.contiguous(), dims


def level_offsets(dims):
    off, offs = 0, []
    for h, w in dims:
        offs.append(off)
        off += h * w
    return offs, off


def level_scales(n_levels: int, pyramid_ratio: float):
    """Per-level (s, 1/s) in float32, computed as the reference does:
    s = f32(1 / inv_ratio**lvl), then 1/s in f32."""
    inv_ratio = 1.0 / pyramid_ratio
    s = [np.float32(1.0 / (inv_ratio ** lvl)) for lvl in range(n_levels)]
    return s, [np.float32(1.0) / v for v in s]


def _check_inputs(src, dst, dims, pos, alive, cam):
    if len(dims) < 1 or len(dims) > MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} pyramid levels, got {len(dims)}")
    _, total = level_offsets(dims)
    n = pos.shape[0]
    for name, t, dtype, shape in (
            ("src", src, torch.float32, (src.shape[0], total)),
            ("dst", dst, torch.float32, (src.shape[0], total)),
            ("pos", pos, torch.float32, (n, 2)),
            ("alive", alive, torch.bool, (n,)),
            ("cam", cam, torch.int32, (n,))):
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load libklt_bidir; returns build.Built."""
    from .build import build_library

    built = build_library("klt_bidir", ["klt_bidir.cu"])
    fn = built.lib.klt_bidir_launch
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn.argtypes = [p, p, ll, p, p, p, p, p, p, i, i,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_float),
                   i, f, f, i, f, i, p]
    fn.restype = ctypes.c_int
    return built


def klt_bidir(src, dst, dims, pos, alive, cam, *, max_iterations: int = 20,
              conv_thresh_sq: float = 1e-4, bidir_thresh_sq: float = 0.4,
              residual_mode: str = "lssd", lm_lambda: float = 0.0,
              pyramid_ratio: float = 0.5, coarse_tolerant: bool = False,
              with_rotation: bool = False):
    """One bidirectional coarse-to-fine KLT pass over packed pyramids.

    Replaces ``track_bidirectional_pyramid`` (rsvio_tpu/ops/pallas/
    klt_kernel.py:737, kernel body ``_klt_bidir_kernel`` :652). On the
    H100 the kernel is bound by per-feature latency — a chain of dependent
    window loads and block reductions, up to 2 x levels x (1 +
    max_iterations) long — not by bandwidth: at 512 features the images sit
    in L2. The design gives each feature a whole 256-thread block (one
    thread per pattern point) so each link of the chain is short, and lets
    each feature leave its loop as soon as it converges or fails.

    Args:
      src, dst: (C, T) float32 packed pyramids (``pack_pyramids``).
      dims: ((H_0, W_0), ..., (H_{L-1}, W_{L-1})) level shapes.
      pos: (N, 2) float32 source positions, full-res px.
      alive: (N,) bool; cam: (N,) int32 camera index per feature.
    Returns (pos_fwd (N, 2), theta (N,) zeros, ok (N,) bool). A feature whose
    forward track fails keeps its source position.
    """
    if with_rotation:
        raise NotImplementedError(
            "the rotation variant of the KLT kernel is not ported yet "
            "(ROADMAP B4)")
    if residual_mode not in ("lssd", "ssd"):
        raise ValueError(f"residual_mode {residual_mode!r}")
    _check_inputs(src, dst, dims, pos, alive, cam)
    kw = dict(max_iterations=max_iterations, conv_thresh_sq=conv_thresh_sq,
              bidir_thresh_sq=bidir_thresh_sq, residual_mode=residual_mode,
              lm_lambda=lm_lambda, pyramid_ratio=pyramid_ratio,
              coarse_tolerant=coarse_tolerant)
    if pos.device.type == "cpu":
        return klt_bidir_reference(src, dst, dims, pos, alive, cam, **kw)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")

    fn = load_library().lib.klt_bidir_launch
    n, L = pos.shape[0], len(dims)
    offs, total = level_offsets(dims)
    s, inv_s = level_scales(L, pyramid_ratio)
    out_pos = torch.empty_like(pos)
    out_theta = torch.empty(n, dtype=torch.float32, device=pos.device)
    out_ok = torch.empty(n, dtype=torch.bool, device=pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    rc = fn(src.data_ptr(), dst.data_ptr(), total, pos.data_ptr(),
            alive.data_ptr(), cam.data_ptr(), out_pos.data_ptr(),
            out_theta.data_ptr(), out_ok.data_ptr(), n, L,
            (ctypes.c_int * L)(*[d[0] for d in dims]),
            (ctypes.c_int * L)(*[d[1] for d in dims]),
            (ctypes.c_longlong * L)(*offs),
            (ctypes.c_float * L)(*[float(v) for v in s]),
            (ctypes.c_float * L)(*[float(v) for v in inv_s]),
            int(max_iterations), float(conv_thresh_sq),
            float(bidir_thresh_sq), int(residual_mode == "ssd"),
            float(lm_lambda), int(bool(coarse_tolerant)), stream)
    if rc != 0:
        raise RuntimeError(f"klt_bidir launch failed with code {rc}")
    klt_bidir.launches += 1
    return out_pos, out_theta, out_ok


klt_bidir.launches = 0   # kernel launches made by klt_bidir (not the plain version)


# ---------------------------------------------------------------------------
# Plain PyTorch version: the same dense-pattern math, batched over features.
# ---------------------------------------------------------------------------

def _in_margin(p, h: int, w: int):
    return ((p[:, 0] >= MARGIN) & (p[:, 1] >= MARGIN)
            & (p[:, 0] <= w - 1 - MARGIN) & (p[:, 1] <= h - 1 - MARGIN))


def _windows(img, off: int, h: int, w: int, cam, p):
    """(N, WIN, WIN) windows with index (CENTER, CENTER) at floor(p), every
    pixel coordinate clamped into the image (edge replication)."""
    fl = torch.clamp(torch.nan_to_num(torch.floor(p), nan=-1e6), -1e6, 1e6)
    base = fl.to(torch.int64) - CENTER
    ar = torch.arange(WIN, device=p.device)
    xs = torch.clamp(base[:, 0:1] + ar, 0, w - 1)
    ys = torch.clamp(base[:, 1:2] + ar, 0, h - 1)
    idx = off + ys[:, :, None] * w + xs[:, None, :]
    return img[cam.to(torch.int64)[:, None, None], idx]


def _lerp(v00, v01, v10, v11, fx, fy):
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _sl(win, dy: int, dx: int):
    return win[:, 1 + dy:1 + dy + PATCH, 1 + dx:1 + dx + PATCH]


def _sample(win, fx, fy):
    return _lerp(_sl(win, 0, 0), _sl(win, 0, 1), _sl(win, 1, 0),
                 _sl(win, 1, 1), fx, fy)


def _sum12(x):
    return x.sum(dim=2).sum(dim=1)


def _frac3(v):
    return (v - torch.floor(v))[:, None, None]


def _level_pass_reference(src, dst, off, h, w, cam, pos_t, pos_i, alive,
                          max_iterations, conv_thresh_sq, ssd, lm_lambda):
    """One level of IC-KLT for all features (level coordinates). Returns
    (final positions (N, 2), ok (N,))."""
    npts = float(PATCH * PATCH)
    win = _windows(src, off, h, w, cam, pos_t)
    fx, fy = _frac3(pos_t[:, 0]), _frac3(pos_t[:, 1])
    val = _sample(win, fx, fy)
    sl = functools.partial(_sl, win)
    gx = _lerp(sl(0, 1) - sl(0, -1), sl(0, 2) - sl(0, 0),
               sl(1, 1) - sl(1, -1), sl(1, 2) - sl(1, 0), fx, fy) * 0.5
    gy = _lerp(sl(1, 0) - sl(-1, 0), sl(1, 1) - sl(-1, 1),
               sl(2, 0) - sl(0, 0), sl(2, 1) - sl(0, 1), fx, fy) * 0.5
    mean = _sum12(val) / npts
    mean3 = torch.clamp(mean, min=_MIN_MEAN)[:, None, None]
    if ssd:
        tmpl, jx, jy = val, gx, gy
    else:
        tmpl = val / mean3
        jx = (gx - tmpl * (_sum12(gx) / npts)[:, None, None]) / mean3
        jy = (gy - tmpl * (_sum12(gy) / npts)[:, None, None]) / mean3
    hxx, hxy, hyy = _sum12(jx * jx), _sum12(jx * jy), _sum12(jy * jy)
    energy = hxx + hyy
    hxx_d, hyy_d = hxx + lm_lambda, hyy + lm_lambda
    det = hxx_d * hyy_d - hxy * hxy
    det_s = torch.where(torch.abs(det) > _DET_EPS, det, torch.ones_like(det))
    a = (hyy_d / det_s)[:, None, None]
    b = (-hxy / det_s)[:, None, None]
    d = (hxx_d / det_s)[:, None, None]
    hjx = a * jx + b * jy
    hjy = b * jx + d * jy
    patch_ok = (_in_margin(pos_t, h, w) & (ssd | (mean > _MIN_MEAN))
                & (energy > (_MIN_GRAD_ENERGY_SSD if ssd else _MIN_GRAD_ENERGY))
                & (torch.abs(det) > _DET_EPS))

    p = pos_i.clone()
    okf = patch_ok.clone()
    active = alive & patch_ok
    for _ in range(max_iterations):
        if not bool(active.any()):
            break       # every feature frozen: further iterations change nothing
        win = _windows(dst, off, h, w, cam, p)
        in_img = _in_margin(p, h, w)
        v = _sample(win, _frac3(p[:, 0]), _frac3(p[:, 1]))
        if ssd:
            r = v - tmpl
        else:
            m = torch.clamp(_sum12(v) / npts, min=_MIN_MEAN)
            r = v / m[:, None, None] - tmpl
        inc = torch.stack([-_sum12(hjx * r), -_sum12(hjy * r)], dim=1)
        inc_sq = inc[:, 0] * inc[:, 0] + inc[:, 1] * inc[:, 1]
        step_ok = in_img & torch.isfinite(inc_sq) & (inc_sq < 1e12)
        do = active & step_ok
        p = torch.where(do[:, None], p + inc, p)
        okf = okf & torch.where(active, step_ok, torch.ones_like(step_ok))
        active = active & step_ok & (inc_sq >= conv_thresh_sq)
    return p, okf & _in_margin(p, h, w) & alive


def klt_bidir_reference(src, dst, dims, pos, alive, cam, *,
                        max_iterations: int = 20, conv_thresh_sq: float = 1e-4,
                        bidir_thresh_sq: float = 0.4,
                        residual_mode: str = "lssd", lm_lambda: float = 0.0,
                        pyramid_ratio: float = 0.5,
                        coarse_tolerant: bool = False,
                        with_rotation: bool = False):
    """Plain PyTorch version of ``klt_bidir`` (same arguments and results):
    the port's path on the CPU, and what the kernel is checked against on
    the card."""
    if with_rotation:
        raise NotImplementedError(
            "the rotation variant of the KLT kernel is not ported yet "
            "(ROADMAP B4)")
    offs, _ = level_offsets(dims)
    s_all, inv_all = level_scales(len(dims), pyramid_ratio)
    ssd = residual_mode == "ssd"

    def run_direction(tmpl_full, a_img, b_img, alive0):
        cur = pos.clone()
        ok_acc = alive0
        for lvl in reversed(range(len(dims))):
            s = torch.tensor(s_all[lvl], dtype=pos.dtype, device=pos.device)
            inv_s = torch.tensor(inv_all[lvl], dtype=pos.dtype,
                                 device=pos.device)
            h, w = dims[lvl]
            p_o, lvl_ok = _level_pass_reference(
                a_img, b_img, offs[lvl], h, w, cam, tmpl_full * s, cur * s,
                alive0, max_iterations, conv_thresh_sq, ssd, lm_lambda)
            cur = torch.where(lvl_ok[:, None], p_o * inv_s, cur)
            if (not coarse_tolerant) or lvl == 0:
                ok_acc = ok_acc & lvl_ok
        return cur, ok_acc

    cur_f, ok_fwd = run_direction(pos, src, dst, alive)
    pos_fwd = torch.where(ok_fwd[:, None], cur_f, pos)
    back, ok_bwd = run_direction(pos_fwd, dst, src, ok_fwd)
    d = back - pos
    ok = ok_fwd & ok_bwd & ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                            < bidir_thresh_sq)
    theta = torch.zeros(pos.shape[0], dtype=pos.dtype, device=pos.device)
    return pos_fwd, theta, ok
