"""Visualization: the artifact-file viewer for headless runs and the no-op
fallback (port of rsvio_tpu/viewers; the rerun viewer is ROADMAP A18)."""

from .artifacts import ArtifactViewer
from .base import NullViewer, Viewer, create_viewer, get_feature_color

__all__ = ["Viewer", "NullViewer", "ArtifactViewer", "create_viewer",
           "get_feature_color"]
