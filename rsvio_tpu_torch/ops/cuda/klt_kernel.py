"""Inverse-compositional KLT: the hand-written Hopper kernels, their
wrappers, and their plain PyTorch versions.

Counterpart of rsvio_tpu/ops/pallas/klt_kernel.py. One CUDA source
(``csrc/klt_bidir.cu``) holds both kernels, each in a translation (2-dof)
and an SE2 rotation (3-dof) variant, on one warp-per-feature level stage:

- ``klt_bidir`` replaces ``track_bidirectional_pyramid`` /
  ``_klt_bidir_kernel``: one launch tracks every feature forward over all
  pyramid levels (coarse to fine), backward from the forward result, and
  applies the return-distance gate.
- ``klt_level`` replaces ``track_level`` / ``_klt_level_kernel``: one level,
  one direction.

The per-level body of both is the TPU kernel's ``_level_pass``: a dense
16x16 unit-spacing patch, bilinear samples and bilinearly interpolated
central-difference gradients, LSSD (or SSD) residuals, a 2x2 (or, with
rotation, 3x3) Gauss-Newton system plus fixed Levenberg damping, per-feature
freeze on convergence or failure. The rotation variant samples each pattern
point bilinearly at its rotated position, keeps the template unrotated, gates
the angle step at theta^2 < 0.12 and rotates the translation increment into
the current warp frame.

Images for ``klt_bidir`` come as one packed (C, sum_l H_l*W_l) float32
buffer per pyramid (``pack_pyramids``): level l of camera c is
``buf[c, off_l:off_l+H_l*W_l]`` viewed as (H_l, W_l); positions are
full-resolution pixels (x, y). ``klt_level`` takes one level as (C, H, W)
images and positions in level coordinates.

Routing: a CUDA tensor always goes to the kernel, a CPU tensor to the plain
version (``klt_bidir_reference``, ``klt_level_reference``). There is no
fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .build import KernelError

PATCH = 16
MARGIN = 2.0      # center-validity margin in px
MAX_LEVELS = 8
MAX_THETA_SQ = 0.12   # theta step gate of the rotation variant
_MIN_GRAD_ENERGY = 1e-4
_MIN_GRAD_ENERGY_SSD = 1e-4 * 255.0 ** 2
_MIN_MEAN = 1e-3
_DET_EPS = 1e-12


def win_geom(with_rotation: bool):
    """(window edge, window index of floor(position), pattern base): 20/9/1
    for translation; 25/12/4 for rotation, whose rotated taps reach +-4 (+1)
    px further at the theta gate."""
    return (25, 12, 4) if with_rotation else (20, 9, 1)


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


def _check(device, specs):
    """Raise unless every (name, tensor, dtype, shape) matches, is
    contiguous and lies on `device`."""
    for name, t, dtype, shape in specs:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, pos on {device}")


def _check_mode(residual_mode):
    if residual_mode not in ("lssd", "ssd"):
        raise ValueError(f"residual_mode {residual_mode!r}")


def _route(device):
    """True for the kernel (CUDA tensors), False for the plain version (CPU
    tensors); raises for any other device."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return True


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the port's CUDA library: the KLT
    kernels and the window solve's assembly (ba_kernel), one nvcc call;
    returns build.Built."""
    from .build import build_library

    built = build_library("rsvio_cuda", ["klt_bidir.cu", "ba_assemble.cu"])
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn = built.lib.klt_bidir_launch
    fn.argtypes = [p, p, ll, p, p, p, p, p, p, i, i,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_float),
                   i, f, f, i, f, i, i, p]
    fn.restype = ctypes.c_int
    fn = built.lib.klt_level_launch
    fn.argtypes = [p, p, ll, i, i, p, p, p, p, p, p, p, p, i, i, f, i, f, i,
                   p]
    fn.restype = ctypes.c_int
    return built


def klt_bidir(src, dst, dims, pos, alive, cam, *, max_iterations: int = 20,
              conv_thresh_sq: float = 1e-4, bidir_thresh_sq: float = 0.4,
              residual_mode: str = "lssd", lm_lambda: float = 0.0,
              pyramid_ratio: float = 0.5, coarse_tolerant: bool = False,
              with_rotation: bool = False):
    """One bidirectional coarse-to-fine KLT pass over packed pyramids.

    Replaces ``track_bidirectional_pyramid`` (rsvio_tpu/ops/pallas/
    klt_kernel.py:737, kernel body ``_klt_bidir_kernel`` :652), translation
    or (``with_rotation``) SE2. On the H100 the kernel is bound by the
    latency of each feature's dependent chain — a template and its
    Gauss-Newton steps per level and direction, up to
    2 x levels x (1 + max_iterations) links (``work["chain"]`` of the plain
    version counts them) — not by bytes or operations. The design shortens
    each link: one warp per feature (8 pattern points a lane, sums by warp
    shuffles, no block barrier), a 32x32 tile of the target level staged in
    shared memory once per level so Gauss-Newton steps read no global
    memory (re-staged only when the iterate leaves it), and the template
    window and first tile copied in one round trip. Each feature leaves its
    loops as soon as it converges or fails.

    Args:
      src, dst: (C, T) float32 packed pyramids (``pack_pyramids``).
      dims: ((H_0, W_0), ..., (H_{L-1}, W_{L-1})) level shapes.
      pos: (N, 2) float32 source positions, full-res px.
      alive: (N,) bool; cam: (N,) int32 camera index per feature.
    Returns (pos_fwd (N, 2), theta (N,) forward angle (zeros without
    rotation), ok (N,) bool). A feature whose forward track fails keeps its
    source position.
    """
    _check_mode(residual_mode)
    if len(dims) < 1 or len(dims) > MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} pyramid levels, got {len(dims)}")
    _, total = level_offsets(dims)
    n = pos.shape[0]
    _check(pos.device, (
        ("src", src, torch.float32, (src.shape[0], total)),
        ("dst", dst, torch.float32, (src.shape[0], total)),
        ("pos", pos, torch.float32, (n, 2)),
        ("alive", alive, torch.bool, (n,)),
        ("cam", cam, torch.int32, (n,))))
    kw = dict(max_iterations=max_iterations, conv_thresh_sq=conv_thresh_sq,
              bidir_thresh_sq=bidir_thresh_sq, residual_mode=residual_mode,
              lm_lambda=lm_lambda, pyramid_ratio=pyramid_ratio,
              coarse_tolerant=coarse_tolerant, with_rotation=with_rotation)
    if not _route(pos.device):
        return klt_bidir_reference(src, dst, dims, pos, alive, cam, **kw)

    fn = load_library().lib.klt_bidir_launch
    L = len(dims)
    offs, _ = level_offsets(dims)
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
            float(lm_lambda), int(bool(coarse_tolerant)),
            int(bool(with_rotation)), stream)
    if rc != 0:
        raise KernelError(f"klt_bidir launch failed with code {rc}")
    if with_rotation:
        klt_bidir.rot_launches += 1
    else:
        klt_bidir.launches += 1
    return out_pos, out_theta, out_ok


# Kernel launches made by klt_bidir (never by the plain version): the
# translation kernel and the rotation kernel.
klt_bidir.launches = 0
klt_bidir.rot_launches = 0


def klt_level(src, dst, pos_src, pos_dst0, theta0, alive, cam, *,
              max_iterations: int = 20, conv_thresh_sq: float = 1e-4,
              residual_mode: str = "lssd", lm_lambda: float = 0.0,
              with_rotation: bool = False):
    """One pyramid level, one direction of IC-KLT for every feature.

    Replaces ``track_level`` (rsvio_tpu/ops/pallas/klt_kernel.py:555, kernel
    body ``_klt_level_kernel`` :509; ``track_level_translation`` :638 is
    this with ``with_rotation=False``). Same bound and design as
    ``klt_bidir``, whose level stage it runs once per feature: one warp per
    feature, the template window and a 32x32 tile of ``dst`` around the
    start copied to shared memory together, Gauss-Newton steps reading the
    tile (re-staged when the iterate leaves it); latency-bound. With
    rotation, a non-finite ``theta0`` takes no step (its samples are NaN)
    and fails.

    Args:
      src, dst: (C, H, W) float32 level images (C cameras, packed).
      pos_src: (N, 2) template centers, level coordinates (x, y).
      pos_dst0: (N, 2) start positions in dst, level coordinates.
      theta0: (N,) start angle (used by the rotation variant only).
      alive: (N,) bool; cam: (N,) int32 camera index per feature.
    Returns (pos (N, 2), theta (N,), ok (N,) bool); ok is the level's ok
    and alive. pos and theta are the last Gauss-Newton iterate, also where
    the level fails; a dead feature keeps pos_dst0 and theta0.
    """
    _check_mode(residual_mode)
    n = pos_src.shape[0]
    if src.dim() != 3:
        raise ValueError(f"src: expected (C, H, W), got {tuple(src.shape)}")
    C, h, w = src.shape
    _check(pos_src.device, (
        ("src", src, torch.float32, (C, h, w)),
        ("dst", dst, torch.float32, (C, h, w)),
        ("pos_src", pos_src, torch.float32, (n, 2)),
        ("pos_dst0", pos_dst0, torch.float32, (n, 2)),
        ("theta0", theta0, torch.float32, (n,)),
        ("alive", alive, torch.bool, (n,)),
        ("cam", cam, torch.int32, (n,))))
    kw = dict(max_iterations=max_iterations, conv_thresh_sq=conv_thresh_sq,
              residual_mode=residual_mode, lm_lambda=lm_lambda,
              with_rotation=with_rotation)
    if not _route(pos_src.device):
        return klt_level_reference(src, dst, pos_src, pos_dst0, theta0,
                                   alive, cam, **kw)

    fn = load_library().lib.klt_level_launch
    dev = pos_src.device
    out_pos = torch.empty_like(pos_src)
    out_theta = torch.empty(n, dtype=torch.float32, device=dev)
    out_ok = torch.empty(n, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(src.data_ptr(), dst.data_ptr(), h * w, h, w, pos_src.data_ptr(),
            pos_dst0.data_ptr(), theta0.data_ptr(), alive.data_ptr(),
            cam.data_ptr(), out_pos.data_ptr(), out_theta.data_ptr(),
            out_ok.data_ptr(), n, int(max_iterations), float(conv_thresh_sq),
            int(residual_mode == "ssd"), float(lm_lambda),
            int(bool(with_rotation)), stream)
    if rc != 0:
        raise KernelError(f"klt_level launch failed with code {rc}")
    klt_level.launches += 1
    return out_pos, out_theta, out_ok


klt_level.launches = 0   # kernel launches made by klt_level, both variants


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same dense-pattern math, batched over features.
# ---------------------------------------------------------------------------

def _in_margin(p, h: int, w: int):
    return ((p[:, 0] >= MARGIN) & (p[:, 1] >= MARGIN)
            & (p[:, 0] <= w - 1 - MARGIN) & (p[:, 1] <= h - 1 - MARGIN))


def _base(p, center: int):
    """(N, 2) int64 image coordinate of window index 0: floor(p) - center,
    non-finite and far-away positions clamped to +-1e6."""
    fl = torch.clamp(torch.nan_to_num(torch.floor(p), nan=-1e6), -1e6, 1e6)
    return fl.to(torch.int64) - center


def _pixels(img, off: int, h: int, w: int, cam, ys, xs):
    """img[cam, off + clamp(ys) * w + clamp(xs)] for (N, ...) index grids:
    edge replication."""
    idx = off + torch.clamp(ys, 0, h - 1) * w + torch.clamp(xs, 0, w - 1)
    c = cam.to(torch.int64).reshape((-1,) + (1,) * (idx.dim() - 1))
    return img[c, idx]


def _touch(work, img, off: int, h: int, w: int, cam, ys, xs, rows):
    """Mark in ``work["touched"]`` (one flat bool mask per image buffer,
    keyed by its data pointer) the pixels ``_pixels`` reads for the same
    arguments, for the features selected by `rows` only."""
    if work is None:
        return
    idx = off + torch.clamp(ys, 0, h - 1) * w + torch.clamp(xs, 0, w - 1)
    c = cam.to(torch.int64).reshape((-1,) + (1,) * (idx.dim() - 1))
    flat = (c * img.shape[1] + idx)[rows]
    mask = work.setdefault("touched", {}).setdefault(
        img.data_ptr(), torch.zeros(img.numel(), dtype=torch.bool,
                                    device=img.device))
    mask[flat.reshape(-1)] = True


def _windows(img, off: int, h: int, w: int, cam, p, edge: int, center: int):
    """(N, edge, edge) windows with index (center, center) at floor(p),
    every pixel coordinate clamped into the image."""
    base = _base(p, center)
    ar = torch.arange(edge, device=p.device)
    return _pixels(img, off, h, w, cam, (base[:, 1:2] + ar)[:, :, None],
                   (base[:, 0:1] + ar)[:, None, :])


def _lerp(v00, v01, v10, v11, fx, fy):
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _sum12(x):
    return x.sum(dim=2).sum(dim=1)


def _frac3(v):
    return (v - torch.floor(v))[:, None, None]


def _b3(v):
    return v[:, None, None]


def _hat(d, k):
    """max(0, 1 - |d - k|), NaN kept (as jnp.maximum)."""
    t = 1.0 - torch.abs(d - k)
    return torch.where(t < 0.0, torch.zeros_like(t), t)


def _rot_sample(img, off, h, w, cam, p, dx, dy, b: int, center: int,
                work=None, rows=None):
    """Bilinear samples of the 16x16 pattern displaced by (dx, dy) window
    pixels from its unrotated taps (the kernel's rot_sample): taps at
    floor(d) and floor(d) + 1 with hat weights, read from the image with
    clamped coordinates (what the kernel's window holds). With ``work``,
    the taps of the `rows` features are marked as read (``_touch``)."""
    kx = torch.clamp(torch.nan_to_num(torch.floor(dx), nan=-64.0), -64, 64)
    ky = torch.clamp(torch.nan_to_num(torch.floor(dy), nan=-64.0), -64, 64)
    wx0, wx1 = _hat(dx, kx), _hat(dx, kx + 1.0)
    wy0, wy1 = _hat(dy, ky), _hat(dy, ky + 1.0)
    base = _base(p, center)
    ar = torch.arange(PATCH, device=p.device)
    xs = _b3(base[:, 0]) + b + ar[None, None, :] + kx.to(torch.int64)
    ys = _b3(base[:, 1]) + b + ar[None, :, None] + ky.to(torch.int64)
    v00 = _pixels(img, off, h, w, cam, ys, xs)
    v01 = _pixels(img, off, h, w, cam, ys, xs + 1)
    v10 = _pixels(img, off, h, w, cam, ys + 1, xs)
    v11 = _pixels(img, off, h, w, cam, ys + 1, xs + 1)
    for dy_, dx_ in ((0, 0), (0, 1), (1, 0), (1, 1)):
        _touch(work, img, off, h, w, cam, ys + dy_, xs + dx_, rows)
    return wy0 * (wx0 * v00 + wx1 * v01) + wy1 * (wx0 * v10 + wx1 * v11)


def _level_pass_reference(src, dst, off, h, w, cam, pos_t, pos_i, theta,
                          alive, max_iterations, conv_thresh_sq, ssd,
                          lm_lambda, rot, work=None):
    """One level of IC-KLT for all features (level coordinates). Returns
    (final positions (N, 2), final angles (N,), ok (N,)); ok includes
    alive. ``work``, when given, is a dict whose "templates" and
    "iterations" counts grow by the templates built and the Gauss-Newton
    steps taken (per feature), whose "chain" — an (N,) int64 tensor,
    created at the first call — grows per feature by the same two counts
    (the links of the dependent chain a kernel walks for that feature), and
    whose "touched" masks (``_touch``) gain the pixels those read: the 19x19
    template support and each step's 17x17 support (rotation: its taps) —
    the work and the image bytes the kernel needs on these inputs."""
    npts = float(PATCH * PATCH)
    edge, center, b = win_geom(rot)
    win = _windows(src, off, h, w, cam, pos_t, edge, center)
    if work is not None:
        base = _base(pos_t, center) + b - 1
        ar = torch.arange(PATCH + 3, device=pos_t.device)
        _touch(work, src, off, h, w, cam, (base[:, 1:2] + ar)[:, :, None],
               (base[:, 0:1] + ar)[:, None, :], alive)

    def sl(dy, dx):
        return win[:, b + dy:b + dy + PATCH, b + dx:b + dx + PATCH]

    fx, fy = _frac3(pos_t[:, 0]), _frac3(pos_t[:, 1])
    val = _lerp(sl(0, 0), sl(0, 1), sl(1, 0), sl(1, 1), fx, fy)
    gx = _lerp(sl(0, 1) - sl(0, -1), sl(0, 2) - sl(0, 0),
               sl(1, 1) - sl(1, -1), sl(1, 2) - sl(1, 0), fx, fy) * 0.5
    gy = _lerp(sl(1, 0) - sl(-1, 0), sl(1, 1) - sl(-1, 1),
               sl(2, 0) - sl(0, 0), sl(2, 1) - sl(0, 1), fx, fy) * 0.5
    ar = torch.arange(PATCH, dtype=pos_t.dtype, device=pos_t.device) - 8.0
    xc, yc = ar[None, None, :], ar[None, :, None]
    mean = _sum12(val) / npts
    mean3 = _b3(torch.clamp(mean, min=_MIN_MEAN))
    gt = gy * xc - gx * yc if rot else None
    if ssd:
        tmpl, jx, jy, jt = val, gx, gy, gt
    else:
        tmpl = val / mean3
        jx = (gx - tmpl * _b3(_sum12(gx) / npts)) / mean3
        jy = (gy - tmpl * _b3(_sum12(gy) / npts)) / mean3
        jt = (gt - tmpl * _b3(_sum12(gt) / npts)) / mean3 if rot else None
    hxx, hxy, hyy = _sum12(jx * jx), _sum12(jx * jy), _sum12(jy * jy)
    energy = hxx + hyy
    hxx_d, hyy_d = hxx + lm_lambda, hyy + lm_lambda
    if rot:
        hxt, hyt = _sum12(jx * jt), _sum12(jy * jt)
        htt_d = _sum12(jt * jt) + lm_lambda
        c00 = hyy_d * htt_d - hyt * hyt
        c01 = hxt * hyt - hxy * htt_d
        c02 = hxy * hyt - hxt * hyy_d
        c11 = hxx_d * htt_d - hxt * hxt
        c12 = hxy * hxt - hxx_d * hyt
        c22 = hxx_d * hyy_d - hxy * hxy
        det = hxx_d * c00 + hxy * c01 + hxt * c02
        det_s = torch.where(torch.abs(det) > _DET_EPS, det,
                            torch.ones_like(det))
        hjx = (_b3(c00 / det_s) * jx + _b3(c01 / det_s) * jy
               + _b3(c02 / det_s) * jt)
        hjy = (_b3(c01 / det_s) * jx + _b3(c11 / det_s) * jy
               + _b3(c12 / det_s) * jt)
        hjt = (_b3(c02 / det_s) * jx + _b3(c12 / det_s) * jy
               + _b3(c22 / det_s) * jt)
    else:
        det = hxx_d * hyy_d - hxy * hxy
        det_s = torch.where(torch.abs(det) > _DET_EPS, det,
                            torch.ones_like(det))
        hjx = _b3(hyy_d / det_s) * jx + _b3(-hxy / det_s) * jy
        hjy = _b3(-hxy / det_s) * jx + _b3(hxx_d / det_s) * jy
    patch_ok = (_in_margin(pos_t, h, w) & (ssd | (mean > _MIN_MEAN))
                & (energy > (_MIN_GRAD_ENERGY_SSD if ssd else _MIN_GRAD_ENERGY))
                & (torch.abs(det) > _DET_EPS))

    p = pos_i.clone()
    th = theta.clone()
    okf = patch_ok.clone()
    active = alive & patch_ok
    if work is not None:
        work["templates"] += int(alive.sum())
        work.setdefault("chain", torch.zeros(
            alive.shape[0], dtype=torch.int64, device=alive.device))
        work["chain"] += alive
    for _ in range(max_iterations):
        if not bool(active.any()):
            break       # every feature frozen: further iterations change nothing
        if work is not None:
            work["iterations"] += int(active.sum())
            work["chain"] += active
        in_img = _in_margin(p, h, w)
        fxs, fys = _frac3(p[:, 0]), _frac3(p[:, 1])
        if rot:
            c3, s3 = _b3(torch.cos(th)), _b3(torch.sin(th))
            dx = (c3 - 1.0) * xc - s3 * yc + fxs
            dy = s3 * xc + (c3 - 1.0) * yc + fys
            v = _rot_sample(dst, off, h, w, cam, p, dx, dy, b, center, work,
                            active)
        else:
            wv = _windows(dst, off, h, w, cam, p, edge, center)
            if work is not None:
                base = _base(p, center) + b
                ar = torch.arange(PATCH + 1, device=p.device)
                _touch(work, dst, off, h, w, cam,
                       (base[:, 1:2] + ar)[:, :, None],
                       (base[:, 0:1] + ar)[:, None, :], active)
            v = _lerp(wv[:, b:b + PATCH, b:b + PATCH],
                      wv[:, b:b + PATCH, b + 1:b + PATCH + 1],
                      wv[:, b + 1:b + PATCH + 1, b:b + PATCH],
                      wv[:, b + 1:b + PATCH + 1, b + 1:b + PATCH + 1],
                      fxs, fys)
        if ssd:
            r = v - tmpl
        else:
            m = torch.clamp(_sum12(v) / npts, min=_MIN_MEAN)
            r = v / _b3(m) - tmpl
        inc_x, inc_y = -_sum12(hjx * r), -_sum12(hjy * r)
        inc_sq = inc_x * inc_x + inc_y * inc_y
        if rot:
            inc_t = -_sum12(hjt * r)
            th_new = th + inc_t
            c, s = torch.cos(th), torch.sin(th)
            ix, iy = c * inc_x - s * inc_y, s * inc_x + c * inc_y
            inc_sq = inc_sq + inc_t * inc_t
            th_ok = th_new * th_new < MAX_THETA_SQ
        else:
            th_new, ix, iy = th, inc_x, inc_y
            th_ok = torch.ones_like(in_img)
        step_ok = in_img & torch.isfinite(inc_sq) & (inc_sq < 1e12) & th_ok
        do = active & step_ok
        p = torch.where(do[:, None], p + torch.stack([ix, iy], dim=1), p)
        th = torch.where(do, th_new, th)
        okf = okf & torch.where(active, step_ok, torch.ones_like(step_ok))
        active = active & step_ok & (inc_sq >= conv_thresh_sq)
    return p, th, okf & _in_margin(p, h, w) & alive


def coarse_to_fine(n_levels: int, level_fn, state, ok, tolerant: bool):
    """The pyramid policy of every coarse-to-fine loop in the port's Python
    code (the fused kernel's stage loop is its CUDA twin). For each level
    from the coarsest to 0, ``level_fn(lvl, *state)`` returns
    ``(*new_state, lvl_ok)``; a level's result replaces the state only where
    that level is ok, and `ok` accumulates every level's ok — under the
    tolerant policy level 0's only. Returns (state tuple, ok)."""
    for lvl in reversed(range(n_levels)):
        *new, lvl_ok = level_fn(lvl, *state)
        state = tuple(
            torch.where(lvl_ok.reshape(lvl_ok.shape + (1,) * (s.dim() - 1)),
                        v, s) for v, s in zip(new, state))
        if not tolerant or lvl == 0:
            ok = ok & lvl_ok
    return state, ok


def klt_bidir_reference(src, dst, dims, pos, alive, cam, *,
                        max_iterations: int = 20, conv_thresh_sq: float = 1e-4,
                        bidir_thresh_sq: float = 0.4,
                        residual_mode: str = "lssd", lm_lambda: float = 0.0,
                        pyramid_ratio: float = 0.5,
                        coarse_tolerant: bool = False,
                        with_rotation: bool = False, work=None):
    """Plain PyTorch version of ``klt_bidir`` (same arguments and results):
    the port's path on the CPU, and what the kernel is checked against on
    the card. ``work``: see ``_level_pass_reference``."""
    offs, _ = level_offsets(dims)
    s_all, inv_all = level_scales(len(dims), pyramid_ratio)
    ssd = residual_mode == "ssd"

    def run_direction(tmpl_full, a_img, b_img, alive0, th0):
        def level(lvl, cur, th):
            s = torch.tensor(s_all[lvl], dtype=pos.dtype, device=pos.device)
            inv_s = torch.tensor(inv_all[lvl], dtype=pos.dtype,
                                 device=pos.device)
            h, w = dims[lvl]
            p_o, th_o, lvl_ok = _level_pass_reference(
                a_img, b_img, offs[lvl], h, w, cam, tmpl_full * s, cur * s,
                th, alive0, max_iterations, conv_thresh_sq, ssd, lm_lambda,
                with_rotation, work)
            return p_o * inv_s, th_o, lvl_ok

        (cur, th), ok = coarse_to_fine(len(dims), level, (pos, th0), alive0,
                                       coarse_tolerant)
        return cur, th, ok

    zeros = torch.zeros(pos.shape[0], dtype=pos.dtype, device=pos.device)
    cur_f, th_fwd, ok_fwd = run_direction(pos, src, dst, alive, zeros)
    pos_fwd = torch.where(ok_fwd[:, None], cur_f, pos)
    back, _, ok_bwd = run_direction(pos_fwd, dst, src, ok_fwd,
                                    -th_fwd if with_rotation else zeros)
    d = back - pos
    ok = ok_fwd & ok_bwd & ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                            < bidir_thresh_sq)
    return pos_fwd, th_fwd, ok


def klt_level_reference(src, dst, pos_src, pos_dst0, theta0, alive, cam, *,
                        max_iterations: int = 20,
                        conv_thresh_sq: float = 1e-4,
                        residual_mode: str = "lssd", lm_lambda: float = 0.0,
                        with_rotation: bool = False, work=None):
    """Plain PyTorch version of ``klt_level`` (same arguments and
    results). ``work``: see ``_level_pass_reference``."""
    C, h, w = src.shape
    return _level_pass_reference(
        src.reshape(C, h * w), dst.reshape(C, h * w), 0, h, w, cam, pos_src,
        pos_dst0, theta0, alive, max_iterations, conv_thresh_sq,
        residual_mode == "ssd", lm_lambda, with_rotation, work)
