"""Rerun-SDK viewer.

Port of rsvio_tpu/viewers/rerun_viewer.py (ref src/viewers/rerun.rs),
method for method: the RDF view coordinates with origin arrows, the
``frame`` sequence plus a ~30 fps clock (frame_id * 33.3 ms, ref
rerun.rs:343-354), JPEG images at quality 75, poses as translation +
xyzw quaternion, 3D points filtered beyond 300 m (ref rerun.rs:298-306),
pinhole frustums, an orange trajectory line strip (ref rerun.rs:378-410)
and the feature tracker's debug surface. Entity paths follow the
reference schema: stereo/left, stereo/right, pose_current, pose_<i>,
map/points, trajectory/path (ref estimator.rs:272-364).

The SDK is imported at ``initialize``; viewers.create_viewer falls back
to the NullViewer when it is missing. A capability probe at
``initialize`` constructs every archetype and keyword this viewer uses (no
connection needed), so SDK drift refuses loudly at start-up with the
missing capability named. After a good probe, a per-call exception is
taken as connection loss (ref rerun.rs:186-190): logged once, then the
viewer is a no-op.

What differs from the JAX module: ``log_image_equalized`` equalizes the
histogram in numpy (``equalize_hist``, OpenCV's definition) instead of
calling ``cv2.equalizeHist``, so it works without OpenCV.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from ..utils.trajectory import rot_to_quat_np
from .base import Viewer, get_feature_color

log = logging.getLogger(__name__)

_MAX_POINT_DISTANCE = 300.0  # meters (ref rerun.rs:298-306)
_FRAME_DT_S = 0.0333         # synthetic ~30 fps clock (ref rerun.rs:343-354)
_JPEG_QUALITY = 75


def equalize_hist(u8: np.ndarray) -> np.ndarray:
    """Histogram equalization of a uint8 image, as ``cv2.equalizeHist``
    defines it: the first non-empty bin maps to 0, bin i to
    round(cdf_after_first(i) * 255 / (total - hist[first])) in float32
    (round half to even), and a constant image maps to its own value."""
    u8 = np.asarray(u8, np.uint8)
    hist = np.bincount(u8.ravel(), minlength=256)
    if u8.size == 0:
        return u8.copy()
    first = int(np.flatnonzero(hist)[0])
    rest = u8.size - int(hist[first])
    if rest == 0:
        return np.full_like(u8, first)
    scale = np.float32(255.0) / np.float32(rest)
    cdf = np.cumsum(hist) - hist[first]
    lut = np.rint(cdf.astype(np.float32) * scale)
    lut = np.clip(lut, 0, 255).astype(np.uint8)
    lut[:first] = 0
    return lut[u8]


def probe_capabilities(rr) -> list:
    """Exercise every rerun-SDK construction this viewer performs; return the
    list of missing or broken capabilities (empty = fully compatible).

    Constructions only: nothing is logged, so the probe needs no viewer
    process. Each entry is "<name>: <error>" for the start-up warning.
    """
    u8 = np.zeros((2, 2), np.uint8)
    checks = [
        ("ViewCoordinates.RDF", lambda: rr.ViewCoordinates.RDF),
        ("Arrows3D", lambda: rr.Arrows3D(
            vectors=[[0.3, 0, 0]], colors=[[255, 0, 0]])),
        ("set_time_sequence", lambda: rr.set_time_sequence),
        ("set_time_seconds", lambda: rr.set_time_seconds),
        ("Transform3D+Quaternion", lambda: rr.Transform3D(
            translation=[0.0, 0.0, 0.0],
            rotation=rr.Quaternion(xyzw=[0.0, 0.0, 0.0, 1.0]))),
        ("Image.compress", lambda: rr.Image(u8).compress(
            jpeg_quality=_JPEG_QUALITY)),
        ("Image draw_order", lambda: rr.Image(u8, draw_order=1.0)),
        ("Points2D", lambda: rr.Points2D(
            np.zeros((1, 2), np.float32), colors=[(0, 255, 0)], radii=3.0)),
        ("Points2D labels", lambda: rr.Points2D(
            np.zeros((1, 2), np.float32), labels=["0"], radii=2.0)),
        ("Points3D", lambda: rr.Points3D(
            np.zeros((1, 3), np.float32), colors=[(0, 255, 0)], radii=0.02)),
        ("Pinhole", lambda: rr.Pinhole(
            focal_length=[100.0, 100.0], principal_point=[50.0, 50.0],
            width=100, height=100, image_plane_distance=0.3)),
        ("LineStrips3D", lambda: rr.LineStrips3D(
            [np.zeros((2, 3), np.float32)], colors=[[255, 165, 0]])),
        ("DepthImage", lambda: rr.DepthImage(np.zeros((2, 2), np.float32))),
    ]
    missing = []
    for name, fn in checks:
        try:
            fn()
        except Exception as e:
            missing.append(f"{name}: {e!r}")
    return missing


def _u8(img) -> np.ndarray:
    return np.clip(np.asarray(img), 0, 255).astype(np.uint8)


class RerunViewer(Viewer):
    def __init__(self, app_id: str = "rsvio_tpu", spawn: bool = True):
        self._app_id = app_id
        self._spawn = spawn
        self._rr = None
        self._initialized = False
        self._frame_id = 0

    def initialize(self) -> bool:
        try:
            import rerun as rr
        except ImportError:
            return False
        missing = probe_capabilities(rr)
        if missing:
            # SDK drift: refuse loudly at start-up instead of degrading
            # silently mid-run.
            log.warning("rerun SDK incompatible — viewer disabled. Missing "
                        "capabilities: %s", "; ".join(missing))
            return False
        try:
            rr.init(self._app_id, spawn=self._spawn)
            rr.log("/", rr.ViewCoordinates.RDF, static=True)
            # Origin axes arrows (ref rerun.rs:91-130).
            rr.log("origin", rr.Arrows3D(
                vectors=[[0.3, 0, 0], [0, 0.3, 0], [0, 0, 0.3]],
                colors=[[255, 0, 0], [0, 255, 0], [0, 0, 255]]), static=True)
            self._rr = rr
            self._initialized = True
            return True
        except Exception as e:
            log.warning("rerun viewer failed to start: %r", e)
            self._initialized = False
            return False

    def _guard(self):
        return self._initialized and self._rr is not None

    def _degrade(self, where: str, e: Exception) -> None:
        """Connection loss -> no-op (ref rerun.rs:186-190), logged once."""
        log.warning("rerun viewer connection lost in %s (%r) — degrading "
                    "to no-op", where, e)
        self._initialized = False

    def _jpeg(self, u8, **kw):
        return self._rr.Image(u8, **kw).compress(jpeg_quality=_JPEG_QUALITY)

    def set_frame(self, frame_id: int, timestamp_ns: int = 0) -> None:
        if not self._guard():
            return
        self._frame_id = frame_id
        try:
            self._rr.set_time_sequence("frame", frame_id)
            self._rr.set_time_seconds("time", frame_id * _FRAME_DT_S)
        except Exception as e:
            self._degrade("set_frame", e)

    def log_pose(self, path: str, T_W_B: np.ndarray) -> None:
        if not self._guard():
            return
        try:
            T = np.asarray(T_W_B, dtype=np.float64)
            q = rot_to_quat_np(T[:3, :3])  # xyzw
            self._rr.log(path, self._rr.Transform3D(
                translation=T[:3, 3].tolist(),
                rotation=self._rr.Quaternion(xyzw=q.tolist())))
        except Exception as e:
            self._degrade("log_pose", e)

    def log_image_raw(self, path: str, img: np.ndarray) -> None:
        if not self._guard():
            return
        try:
            self._rr.log(path, self._jpeg(_u8(img)))
        except Exception as e:
            self._degrade("log_image_raw", e)

    def log_image_equalized(self, path: str, img: np.ndarray) -> None:
        if not self._guard():
            return
        try:
            self._rr.log(path, self._jpeg(equalize_hist(_u8(img))))
        except Exception as e:
            self._degrade("log_image_equalized", e)

    def log_image_with_features(self, path: str, img: np.ndarray,
                                uv: np.ndarray,
                                ids: Optional[Sequence[int]] = None) -> None:
        self.log_image_raw(path, img)
        if not self._guard():
            return
        try:
            colors = ([get_feature_color(i) for i in ids]
                      if ids is not None else [(0, 255, 0)] * len(uv))
            self._rr.log(path + "/features", self._rr.Points2D(
                np.asarray(uv), colors=colors, radii=3.0))
        except Exception as e:
            self._degrade("log_image_with_features", e)

    def log_image_with_features_colored(self, path, img, uv, ids):
        self.log_image_with_features(path, img, uv, ids)

    def log_points(self, path: str, pts: np.ndarray) -> None:
        self.log_points_colored(path, pts, None)

    def log_points_colored(self, path: str, pts: np.ndarray,
                           ids: Optional[Sequence[int]]) -> None:
        if not self._guard():
            return
        try:
            pts = np.asarray(pts)
            keep = np.linalg.norm(pts, axis=1) < _MAX_POINT_DISTANCE
            colors = None
            if ids is not None:
                colors = [get_feature_color(i)
                          for i in np.asarray(list(ids))[keep]]
            self._rr.log(path, self._rr.Points3D(pts[keep], colors=colors,
                                                 radii=0.02))
        except Exception as e:
            self._degrade("log_points_colored", e)

    def log_camera_frustum(self, path: str, T_W_C: np.ndarray,
                           intrinsics, image_size) -> None:
        if not self._guard():
            return
        try:
            fx, fy, cx, cy = [float(v) for v in intrinsics[:4]]
            w, h = image_size
            self.log_pose(path, T_W_C)
            self._rr.log(path, self._rr.Pinhole(
                focal_length=[fx, fy], principal_point=[cx, cy],
                width=int(w), height=int(h), image_plane_distance=0.3))
        except Exception as e:
            self._degrade("log_camera_frustum", e)

    def log_trajectory(self, path: str, positions: np.ndarray) -> None:
        if not self._guard():
            return
        try:
            self._rr.log(path, self._rr.LineStrips3D(
                [np.asarray(positions)], colors=[[255, 165, 0]]))  # orange
        except Exception as e:
            self._degrade("log_trajectory", e)

    # --- feature-tracker debug surface (ref feature_tracker/src/viewer.rs:6-97)

    def log_labeled_points(self, path: str, uv: np.ndarray, labels) -> None:
        if not self._guard():
            return
        try:
            # +0.5: log at pixel centers (ref viewer.rs log_feature_points).
            self._rr.log(path, self._rr.Points2D(
                np.asarray(uv, dtype=np.float32) + 0.5,
                labels=[str(s) for s in labels], radii=2.0))
        except Exception as e:
            self._degrade("log_labeled_points", e)

    def log_pyramid(self, path: str, pyramid) -> None:
        if not self._guard():
            return
        try:
            for i, level in enumerate(pyramid):
                # Coarser levels drawn on top (ref viewer.rs draw order).
                self._rr.log(f"{path}/level_{i}",
                             self._jpeg(_u8(level), draw_order=float(i)))
        except Exception as e:
            self._degrade("log_pyramid", e)

    def log_float_map(self, path: str, arr: np.ndarray) -> None:
        if not self._guard():
            return
        # Float maps as DepthImage with a colormap (ref viewer.rs:6-97);
        # colormap support varies by SDK version, so its absence is not
        # taken as connection loss.
        cmap = None
        try:
            cmap = self._rr.components.Colormap.Turbo
        except Exception:
            pass
        try:
            a = np.asarray(arr, dtype=np.float32)
            self._rr.log(path, self._rr.DepthImage(a) if cmap is None
                         else self._rr.DepthImage(a, colormap=cmap))
        except Exception as e:
            self._degrade("log_float_map", e)
