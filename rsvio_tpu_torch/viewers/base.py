"""Viewer interface + deterministic feature colors.

Port of rsvio_tpu/viewers/base.py (ref src/viewers/viewer.rs:6-45): the
same visualization surface and the same deterministic id->RGB hashing with
a minimum brightness of 50 (ref src/viewers/mod.rs:16-49). ``create_viewer``
gives the artifact viewer for a directory, the rerun viewer where the SDK
is installed and starts, and the NullViewer otherwise.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np


def get_feature_color(feature_id: int) -> tuple:
    """Deterministic feature id -> (r, g, b), each >= 50 (Knuth-style
    multiplicative hashes per channel, the reference's scheme class)."""
    fid = int(feature_id) & 0xFFFFFFFF
    r = (fid * 2654435761) & 0xFFFFFFFF
    g = (fid * 2246822519) & 0xFFFFFFFF
    b = (fid * 3266489917) & 0xFFFFFFFF
    lo = 50
    span = 256 - lo
    return (lo + (r >> 24) * span // 256,
            lo + (g >> 24) * span // 256,
            lo + (b >> 24) * span // 256)


class Viewer:
    """Visualization interface (ref viewer.rs:6-45)."""

    def initialize(self) -> bool:
        return True

    def set_frame(self, frame_id: int, timestamp_ns: int) -> None: ...

    def log_pose(self, path: str, T_W_B: np.ndarray) -> None: ...

    def log_image_raw(self, path: str, img: np.ndarray) -> None: ...

    def log_image_equalized(self, path: str, img: np.ndarray) -> None: ...

    def log_image_with_features(self, path: str, img: np.ndarray,
                                uv: np.ndarray,
                                ids: Optional[Sequence[int]] = None) -> None: ...

    def log_image_with_features_colored(self, path: str, img: np.ndarray,
                                        uv: np.ndarray,
                                        ids: Sequence[int]) -> None: ...

    def log_points(self, path: str, pts: np.ndarray) -> None: ...

    def log_points_colored(self, path: str, pts: np.ndarray,
                           ids: Sequence[int]) -> None: ...

    def log_camera_frustum(self, path: str, T_W_C: np.ndarray,
                           intrinsics, image_size) -> None: ...

    def log_trajectory(self, path: str, positions: np.ndarray) -> None: ...

    # --- feature-tracker debug surface (ref feature_tracker/src/viewer.rs:6-97)

    def log_labeled_points(self, path: str, uv: np.ndarray,
                           labels: Sequence[str]) -> None:
        """2D feature points with text labels, logged at pixel CENTERS
        (+0.5 offset like ref viewer.rs log_feature_points)."""

    def log_pyramid(self, path: str, pyramid: Sequence[np.ndarray]) -> None:
        """All pyramid levels under `path`/level_<i>, coarser levels drawn
        on top (ref viewer.rs pyramid draw-order semantics)."""

    def log_float_map(self, path: str, arr: np.ndarray) -> None:
        """A float-valued map (corner scores, depth, residuals) rendered
        with a colormap (ref viewer.rs DepthImage logging)."""


class NullViewer(Viewer):
    """No-op viewer (used when no viewer is asked for or none is available;
    degrades the way the reference handles viewer connection loss, ref
    rerun.rs:186-190)."""


def create_viewer(enabled: bool = True, artifact_dir: str = None) -> Viewer:
    """Factory (ref rerun.rs:448): the artifact-writing viewer when a
    directory is given, the rerun-backed viewer when the SDK exists and
    starts, NullViewer otherwise. Without the SDK it logs one warning."""
    if artifact_dir:
        from .artifacts import ArtifactViewer
        return ArtifactViewer(artifact_dir)
    if not enabled:
        return NullViewer()
    try:
        import rerun  # noqa: F401
    except ImportError:
        logging.getLogger("rsvio").warning(
            "--viewer: the rerun SDK (import rerun) is not installed; no "
            "viewer runs. --viewer-dir writes PNG / PLY / SVG artifacts")
        return NullViewer()
    try:
        from .rerun_viewer import RerunViewer
        v = RerunViewer()
        if v.initialize():
            return v
    except Exception:
        pass
    return NullViewer()
