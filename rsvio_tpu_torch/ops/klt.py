"""Batched inverse-compositional KLT tracking on pyramids — the front end's
hot loop.

Port of rsvio_tpu/ops/klt.py. Two routes, chosen by ``resolve_backend``:

- The kernel route (``backend`` "auto" or "pallas"; the JAX package's Pallas
  path): the bidirectional entry points run the fused pass of
  ``ops.cuda.klt_kernel.klt_bidir``, and ``track_points`` runs
  ``klt_level`` once per level, coarse to fine. Translation or, with
  ``track_rotation``, SE2. Hand-written kernels on CUDA tensors, their plain
  PyTorch versions on CPU tensors.
- The gather route (``backend="xla"``, and any bicubic configuration): an
  8x8 pattern at 2 px spacing sampled by gathers, with SE2 warps composed
  through ``lie.se2_exp``, a fixed trip of ``max_iterations`` masked
  Gauss-Newton steps per level. The JAX package runs it per feature (vmap);
  here it is batched over features. It has no kernel in JAX either, so it
  stays plain PyTorch.

The two routes differ by design (different patterns); each is compared with
its own JAX counterpart.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import interp
from .cuda.klt_kernel import (coarse_to_fine, klt_bidir, klt_level,
                              pack_pyramids)
from .lie import se2_exp


class KLTConfig(NamedTuple):
    """Tracking configuration; same fields and defaults as the JAX
    KLTConfig (see rsvio_tpu/ops/klt.py for what each one means)."""
    max_iterations: int = 20
    convergence_threshold: float = 0.01
    levels: int = 6
    bidir_threshold_sq: float = 0.4
    bounds_margin: float = 2.0
    backend: str = "auto"
    track_rotation: bool = False
    residual_mode: str = "lssd"
    lm_lambda: float = 0.0
    interpolation: str = "bilinear"
    coarse_level_policy: str = "tolerant"
    pyramid_ratio: float = 0.5


def resolve_backend(cfg: KLTConfig) -> str:
    """The route a KLTConfig runs on: "pallas" (the kernel route) or "xla"
    (the gather route), as the JAX function names them. Every bilinear
    configuration runs on the kernels unless "xla" is asked for; bicubic
    sampling exists only on the gather route, so it goes there, and asking
    for it with backend "pallas" is an error rather than a silent
    change."""
    if cfg.backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown KLT backend {cfg.backend!r}")
    if cfg.interpolation not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown KLT interpolation {cfg.interpolation!r}")
    if cfg.interpolation == "bicubic":
        if cfg.backend == "pallas":
            raise ValueError(
                "bicubic interpolation is not implemented in the KLT kernel; "
                "use backend='xla' (or 'auto', which routes there)")
        return "xla"
    return "xla" if cfg.backend == "xla" else "pallas"


def theta_to_A(theta):
    """(N,) angles -> (N, 2, 2) rotations."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


# ---------------------------------------------------------------------------
# Kernel route
# ---------------------------------------------------------------------------

def _kernel_kw(cfg: KLTConfig):
    return dict(max_iterations=cfg.max_iterations,
                conv_thresh_sq=cfg.convergence_threshold ** 2,
                residual_mode=cfg.residual_mode, lm_lambda=cfg.lm_lambda,
                with_rotation=cfg.track_rotation)


def _bidir_kernel(src_pyrs, dst_pyrs, pos_src, alive, cfg: KLTConfig,
                  cam=None):
    """One ``klt_bidir`` call. The kernel takes float32 only (as the TPU
    kernel, which writes float32 whatever it is given), so the pyramids and
    positions are cast to float32 here and the results back to the
    caller's dtype; a failed feature keeps the caller's exact source."""
    dtype = pos_src.dtype
    src, dims = pack_pyramids(src_pyrs)
    dst, _ = pack_pyramids(dst_pyrs)
    if cam is None:
        cam = torch.zeros(pos_src.shape[0], dtype=torch.int32,
                          device=pos_src.device)
    pos, theta, ok = klt_bidir(
        src.float(), dst.float(), dims, pos_src.float().contiguous(),
        alive.contiguous(), cam.contiguous(),
        bidir_thresh_sq=cfg.bidir_threshold_sq,
        pyramid_ratio=cfg.pyramid_ratio,
        coarse_tolerant=cfg.coarse_level_policy == "tolerant",
        **_kernel_kw(cfg))
    if dtype != torch.float32:
        pos = torch.where(ok[:, None], pos.to(dtype), pos_src)
    return pos, theta_to_A(theta.to(dtype)), ok


def _track_points_kernel(pyr_src, pyr_dst, pos_src, pos_dst0, A0, alive,
                         cfg: KLTConfig, level_fn=klt_level):
    """Coarse to fine with one ``level_fn`` call per level (``klt_level``;
    ``klt_level_reference`` to check the composition against); the angle is
    carried across levels (it is scale-free) and returned as a rotation.
    The composition runs in float32, the kernel's only dtype, and the
    results are cast back to the caller's dtype."""
    dtype = pos_src.dtype
    pos_in = pos_src
    pyr_src = [lvl.float() for lvl in pyr_src]
    pyr_dst = [lvl.float() for lvl in pyr_dst]
    pos_src, pos_dst0, A0 = pos_src.float(), pos_dst0.float(), A0.float()
    n = pos_src.shape[0]
    cam = torch.zeros(n, dtype=torch.int32, device=pos_src.device)
    alive = alive.contiguous()
    if cfg.track_rotation:
        theta = torch.atan2(A0[:, 1, 0], A0[:, 0, 0])
    else:
        theta = torch.zeros(n, dtype=pos_src.dtype, device=pos_src.device)

    def level(lvl, pos, theta):
        # A Python float: a tensor made from it on the card is a blocking copy.
        scale = (1.0 / cfg.pyramid_ratio) ** lvl
        pos_lvl, theta_lvl, lvl_ok = level_fn(
            pyr_src[lvl][None].contiguous(), pyr_dst[lvl][None].contiguous(),
            (pos_src / scale).contiguous(), (pos / scale).contiguous(),
            theta.contiguous(), alive, cam, **_kernel_kw(cfg))
        return pos_lvl * scale, theta_lvl, lvl_ok

    (pos, theta), ok = coarse_to_fine(
        len(pyr_src), level, (pos_dst0, theta), alive,
        cfg.coarse_level_policy == "tolerant")
    pos = torch.where(ok[:, None], pos.to(dtype), pos_in)
    return pos, theta_to_A(theta.to(dtype)), ok


# ---------------------------------------------------------------------------
# Gather route
# ---------------------------------------------------------------------------

def _pattern(like):
    """Dense 8x8 pattern at spacing 2: (64, 2) offsets (x, y) in
    {-7, -5, ..., 7}^2, x fastest."""
    c = torch.arange(8, dtype=like.dtype, device=like.device) * 2.0 - 7.0
    return torch.stack([c.repeat(8), c.repeat_interleave(8)], dim=1)


# Shared-valid points must exceed this fraction of the template's valid
# points, and a template needs this many valid points.
_MIN_SHARED_FRAC = 0.5
_MIN_TEMPLATE_PTS = 8


class PatchData(NamedTuple):
    data: torch.Tensor       # (N, P) template intensities (normalized in lssd)
    hinv_jt: torch.Tensor    # (N, 3, P) precomputed H^-1 J^T
    valid_pts: torch.Tensor  # (N, P) bool per-point validity
    ok: torch.Tensor         # (N,) bool patch usable


def build_patch(img, center, residual_mode: str = "lssd",
                lm_lambda: float = 0.0, n_dof: int = 3,
                interpolation: str = "bilinear") -> PatchData:
    """Templates at (N, 2) `center`s of `img` plus the precomputed IC step
    operator (J^T J + lm_lambda I)^-1 J^T. n_dof 2 solves translation only
    (the operator's rotation row is zero), 3 full SE2."""
    pattern = _pattern(center)
    pts = center[:, None, :] + pattern
    sample_grad = (interp.bicubic_with_grad if interpolation == "bicubic"
                   else interp.bilinear_with_grad)
    vals, grads, valid = sample_grad(img, pts)
    validf = valid.to(img.dtype)
    n_valid = validf.sum(dim=1)
    n_safe = torch.clamp(n_valid, min=1.0)
    mean = (vals * validf).sum(dim=1) / n_safe
    mean_safe = torch.clamp(mean, min=1e-6)

    # Warp Jacobian at offset (x, y): dW/d[tx, ty, theta] = [[1,0,-y],[0,1,x]]
    gx, gy = grads[..., 0], grads[..., 1]
    if n_dof == 2:
        j_raw = torch.stack([gx, gy], dim=-1)
    else:
        ox, oy = pattern[:, 0], pattern[:, 1]
        j_raw = torch.stack([gx, gy, gx * (-oy) + gy * ox], dim=-1)
    j_raw = j_raw * validf[..., None]

    zero = torch.zeros_like(vals)
    if residual_mode == "ssd":
        data = torch.where(valid, vals, zero)
        jac = j_raw
        mean_ok = torch.ones_like(valid[:, 0])
    else:
        data = torch.where(valid, vals / mean_safe[:, None], zero)
        mean_j = j_raw.sum(dim=1) / n_safe[:, None]
        jac = ((j_raw - data[..., None] * mean_j[:, None, :])
               / mean_safe[:, None, None])
        jac = jac * validf[..., None]
        mean_ok = mean > 1e-3

    jt = jac.transpose(1, 2)                         # (N, n_dof, P)
    H = jt @ jac
    energy = torch.diagonal(H, dim1=1, dim2=2).sum(dim=1)
    energy_floor = 1e-4 if residual_mode != "ssd" else 1e-4 * 255.0 ** 2
    eye = torch.eye(n_dof, dtype=img.dtype, device=img.device)
    H = H + (1e-8 + lm_lambda) * eye
    hinv_jt, info = torch.linalg.solve_ex(H, jt)
    if n_dof == 2:
        hinv_jt = torch.cat([hinv_jt, torch.zeros_like(hinv_jt[:, :1])],
                            dim=1)
    ok = (interp.in_bounds(center, img.shape, 2.0)
          & (n_valid >= _MIN_TEMPLATE_PTS) & mean_ok
          & (energy > energy_floor) & (info == 0)
          & torch.isfinite(hinv_jt).all(dim=2).all(dim=1))
    hinv_jt = torch.where(ok[:, None, None], hinv_jt,
                          torch.zeros_like(hinv_jt))
    return PatchData(data=data, hinv_jt=hinv_jt, valid_pts=valid, ok=ok)


def _patch_residual(img, patch: PatchData, M, residual_mode: str = "lssd",
                    interpolation: str = "bilinear"):
    """Residuals (N, P) of the target samples under the (N, 3, 3) SE2 warps
    M (whose translation is the target position) against the templates,
    and whether enough points are shared."""
    pattern = _pattern(M)
    px, py = pattern[:, 0], pattern[:, 1]
    x = (px * M[:, 0, 0, None] + py * M[:, 0, 1, None]) + M[:, 0, 2, None]
    y = (px * M[:, 1, 0, None] + py * M[:, 1, 1, None]) + M[:, 1, 2, None]
    sample = interp.bicubic if interpolation == "bicubic" else interp.bilinear
    vals, valid = sample(img, torch.stack([x, y], dim=-1))
    valid = valid & patch.valid_pts
    validf = valid.to(img.dtype)
    n_valid = validf.sum(dim=1)
    zero = torch.zeros_like(vals)
    if residual_mode == "ssd":
        r = torch.where(valid, vals - patch.data, zero)
    else:
        n_safe = torch.clamp(n_valid, min=1.0)
        mean = torch.clamp((vals * validf).sum(dim=1) / n_safe, min=1e-6)
        r = torch.where(valid, vals / mean[:, None] - patch.data, zero)
    n_template = patch.valid_pts.to(img.dtype).sum(dim=1)
    return r, n_valid > _MIN_SHARED_FRAC * n_template


def _track_at_level(img_target, patch: PatchData, M0, cfg: KLTConfig):
    """Masked Gauss-Newton at one level: a fixed trip of max_iterations in
    which a feature freezes once it converges or a step fails."""
    M, active, ok = M0, patch.ok, patch.ok
    conv_sq = cfg.convergence_threshold ** 2
    for _ in range(cfg.max_iterations):
        r, r_ok = _patch_residual(img_target, patch, M, cfg.residual_mode,
                                  cfg.interpolation)
        inc = -(patch.hinv_jt @ r[..., None])[..., 0]        # (N, 3)
        inc_norm_sq = (inc * inc).sum(dim=1)
        finite = torch.isfinite(inc).all(dim=1) & (inc_norm_sq < 1e12)
        step_ok = r_ok & finite
        M_new = M @ se2_exp(inc)
        do_step = active & step_ok
        M = torch.where(do_step[:, None, None], M_new, M)
        ok = ok & torch.where(active, step_ok, torch.ones_like(step_ok))
        active = active & step_ok & (inc_norm_sq >= conv_sq)
    ok = ok & interp.in_bounds(M[:, :2, 2], img_target.shape,
                               cfg.bounds_margin)
    return M, ok


def _track_points_gather(pyr_src, pyr_dst, pos_src, pos_dst0, A0,
                         cfg: KLTConfig):
    """Coarse-to-fine tracking of every feature (dead ones too, as the JAX
    vmap does; the caller masks them). Returns (pos, A, ok)."""
    n = pos_src.shape[0]
    n_dof = 3 if cfg.track_rotation else 2

    def level(lvl, pos, A):
        scale = (1.0 / cfg.pyramid_ratio) ** lvl     # a Python float, no copy
        patch = build_patch(pyr_src[lvl], pos_src / scale, cfg.residual_mode,
                            cfg.lm_lambda, n_dof, cfg.interpolation)
        M0 = torch.eye(3, dtype=pos_src.dtype,
                       device=pos_src.device).repeat(n, 1, 1)
        M0[:, :2, :2] = A
        M0[:, :2, 2] = pos / scale
        M, lvl_ok = _track_at_level(pyr_dst[lvl], patch, M0, cfg)
        return M[:, :2, 2] * scale, M[:, :2, :2], lvl_ok

    (pos, A), ok = coarse_to_fine(
        len(pyr_src), level, (pos_dst0, A0),
        torch.ones(n, dtype=torch.bool, device=pos_src.device),
        cfg.coarse_level_policy == "tolerant")
    return pos, A, ok


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def track_points(pyr_src, pyr_dst, pos_src, pos_dst0, A0, alive,
                 cfg: KLTConfig):
    """Track all features pyr_src -> pyr_dst in one direction.

    pyr_src, pyr_dst: tuples of (H_l, W_l) levels; pos_src (N, 2) source
    positions and pos_dst0 (N, 2) start positions (full-res px); A0
    (N, 2, 2) start linear warps; alive (N,) bool. Returns (pos_dst (N, 2),
    A (N, 2, 2), ok (N,)); a failed or dead feature keeps pos_src.
    """
    if resolve_backend(cfg) == "pallas":
        return _track_points_kernel(pyr_src, pyr_dst, pos_src, pos_dst0, A0,
                                    alive, cfg)
    pos, A, ok = _track_points_gather(pyr_src, pyr_dst, pos_src, pos_dst0,
                                      A0, cfg)
    ok = ok & alive
    pos = torch.where(ok[:, None], pos, pos_src)
    return pos, A, ok


def track_points_bidirectional(pyr_src, pyr_dst, pos_src, alive,
                               cfg: KLTConfig):
    """Forward + backward track with the return-distance gate. On the kernel
    route one launch; on the gather route two ``track_points`` passes, the
    backward one started at the source with the inverse (transposed)
    forward rotation. Returns (pos_dst (N, 2), A (N, 2, 2), ok (N,))."""
    if resolve_backend(cfg) == "pallas":
        return _bidir_kernel([pyr_src], [pyr_dst], pos_src, alive, cfg)
    n = pos_src.shape[0]
    eye = torch.eye(2, dtype=pos_src.dtype,
                    device=pos_src.device).expand(n, 2, 2)
    pos_fwd, A_fwd, ok_fwd = track_points(pyr_src, pyr_dst, pos_src,
                                          pos_src, eye, alive, cfg)
    pos_back, _, ok_back = track_points(pyr_dst, pyr_src, pos_fwd, pos_src,
                                        A_fwd.transpose(-1, -2), ok_fwd, cfg)
    dist_sq = ((pos_back - pos_src) ** 2).sum(dim=1)
    ok = ok_fwd & ok_back & (dist_sq < cfg.bidir_threshold_sq)
    return pos_fwd, A_fwd, ok


def track_points_bidirectional_stereo(pyr0_src, pyr1_src, pyr0_dst, pyr1_dst,
                                      pos0, pos1, alive, cfg: KLTConfig):
    """Temporal tracking of both cameras of a stereo rig. On the kernel
    route ONE launch: the two cameras' features are concatenated and each
    carries its camera index into the packed (2, T) pyramids. On the gather
    route two ``track_points_bidirectional`` calls. Returns (pos0, A0, ok0,
    pos1, A1, ok1)."""
    if resolve_backend(cfg) != "pallas":
        return (*track_points_bidirectional(pyr0_src, pyr0_dst, pos0, alive,
                                            cfg),
                *track_points_bidirectional(pyr1_src, pyr1_dst, pos1, alive,
                                            cfg))
    N = pos0.shape[0]
    cam = torch.cat([torch.zeros(N, dtype=torch.int32, device=pos0.device),
                     torch.ones(N, dtype=torch.int32, device=pos0.device)])
    pos, A, ok = _bidir_kernel([pyr0_src, pyr1_src], [pyr0_dst, pyr1_dst],
                               torch.cat([pos0, pos1]),
                               torch.cat([alive, alive]), cfg, cam=cam)
    return pos[:N], A[:N], ok[:N], pos[N:], A[N:], ok[N:]
