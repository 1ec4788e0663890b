"""Batched bidirectional KLT tracking on pyramids — the front end's hot loop.

Port of rsvio_tpu/ops/klt.py for the stereo VO main path. Both entry points
run the fused bidirectional pass of ``ops.cuda.klt_kernel.klt_bidir``: the
hand-written kernel on CUDA tensors, its plain PyTorch version on CPU
tensors. That is the JAX package's Pallas path (``backend="pallas"``, and
what ``"auto"`` picks on a TPU), which is also what ``"auto"`` means here.

Not ported yet: the gather-based ``backend="xla"`` path (8x8 pattern at
spacing 2, a different algorithm; ROADMAP A5), rotation tracking and bicubic
sampling (ROADMAP A15, B4). Asking for them raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda.klt_kernel import klt_bidir, pack_pyramids


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


def check_config(cfg: KLTConfig) -> None:
    """Raise for options the port does not implement yet."""
    if cfg.backend == "xla":
        raise NotImplementedError(
            "the gather-based KLT path (backend='xla') is not ported yet "
            "(ROADMAP A5)")
    if cfg.backend not in ("auto", "pallas"):
        raise ValueError(f"unknown KLT backend {cfg.backend!r}")
    if cfg.interpolation != "bilinear":
        raise NotImplementedError(
            "bicubic KLT sampling is not ported yet (ROADMAP A15)")
    if cfg.track_rotation:
        raise NotImplementedError(
            "rotation tracking (the kernel's rotation variant) is not "
            "ported yet (ROADMAP B4)")


def theta_to_A(theta):
    """(N,) angles -> (N, 2, 2) rotations."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def _bidir(src_pyrs, dst_pyrs, pos_src, alive, cfg: KLTConfig, cam=None):
    check_config(cfg)
    src, dims = pack_pyramids(src_pyrs)
    dst, _ = pack_pyramids(dst_pyrs)
    if cam is None:
        cam = torch.zeros(pos_src.shape[0], dtype=torch.int32,
                          device=pos_src.device)
    pos, theta, ok = klt_bidir(
        src, dst, dims, pos_src.contiguous(), alive.contiguous(),
        cam.contiguous(), max_iterations=cfg.max_iterations,
        conv_thresh_sq=cfg.convergence_threshold ** 2,
        bidir_thresh_sq=cfg.bidir_threshold_sq,
        residual_mode=cfg.residual_mode, lm_lambda=cfg.lm_lambda,
        pyramid_ratio=cfg.pyramid_ratio,
        coarse_tolerant=cfg.coarse_level_policy == "tolerant")
    return pos, theta_to_A(theta), ok


def track_points_bidirectional(pyr_src, pyr_dst, pos_src, alive,
                               cfg: KLTConfig):
    """Forward + backward track with the return-distance gate, one kernel
    launch. pyr_src/pyr_dst: tuples of (H_l, W_l) levels; pos_src (N, 2)
    full-res px; alive (N,) bool. Returns (pos_dst (N,2), A (N,2,2),
    ok (N,))."""
    return _bidir([pyr_src], [pyr_dst], pos_src, alive, cfg)


def track_points_bidirectional_stereo(pyr0_src, pyr1_src, pyr0_dst, pyr1_dst,
                                      pos0, pos1, alive, cfg: KLTConfig):
    """Temporal tracking of both cameras of a stereo rig in ONE launch: the
    two cameras' features are concatenated and each feature carries its
    camera index into the packed (2, T) pyramids. Returns (pos0, A0, ok0,
    pos1, A1, ok1)."""
    N = pos0.shape[0]
    cam = torch.cat([torch.zeros(N, dtype=torch.int32, device=pos0.device),
                     torch.ones(N, dtype=torch.int32, device=pos0.device)])
    pos, A, ok = _bidir([pyr0_src, pyr1_src], [pyr0_dst, pyr1_dst],
                        torch.cat([pos0, pos1]), torch.cat([alive, alive]),
                        cfg, cam=cam)
    return pos[:N], A[:N], ok[:N], pos[N:], A[N:], ok[N:]
