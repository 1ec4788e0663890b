"""Visualization: the rerun viewer, the artifact-file viewer for headless
runs and the no-op fallback (port of rsvio_tpu/viewers)."""

from .artifacts import ArtifactViewer
from .base import NullViewer, Viewer, create_viewer, get_feature_color
from .rerun_viewer import RerunViewer

__all__ = ["Viewer", "NullViewer", "ArtifactViewer", "RerunViewer",
           "create_viewer", "get_feature_color"]
