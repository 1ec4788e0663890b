"""Artifact viewer: visualization without any viewer process, SDK or
OpenCV.

Port of rsvio_tpu/viewers/artifacts.py. Writes plain files into a
directory:

  <dir>/frames/<entity>_<frame:06d>.png   images with colored feature dots
  <dir>/<entity>.ply                      latest 3D map (ASCII PLY, colored)
  <dir>/trajectory.txt                    x y z per line (rewritten)
  <dir>/trajectory.svg                    top-down XY path
  <dir>/poses.json                        latest pose per entity path

The files hold what the JAX package's viewer writes: the PNGs the same
pixels (written by ``data.png.write_png``; the dots are the filled radius-3
disc of ``cv2.circle(..., -1)``, the float maps colored by
``cv2.COLORMAP_TURBO``, whose 256 entries are in ``TURBO_RGB``), the PLY,
SVG and text files the same bytes. Unlike the JAX viewer, a failed write
raises.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..data import png
from .base import Viewer, get_feature_color

# cv2.COLORMAP_TURBO as 256 RGB triples.
TURBO_RGB = np.frombuffer(bytes.fromhex(
    "30123b32154333184a341b51351e5836215f37246638276d392a733a2d793b2f"
    "803c32863d358b3e38913f3b973f3e9c4040a24143a74146ac4249b1424bb543"
    "4eba4451bf4454c34456c74559cb455ccf455ed34661d64664da4666dd4669e0"
    "466be3476ee64771e94773eb4776ee4778f0477bf2467df44680f64682f84685"
    "fa4687fb458afc458cfd448ffe4391fe4294ff4196ff4099ff3e9bfe3d9efe3b"
    "a0fd3aa3fc38a5fb37a8fa35abf833adf731aff52fb2f42eb4f22cb7f02ab9ee"
    "28bceb27bee925c0e723c3e422c5e220c7df1fc9dd1ecbda1ccdd81bd0d51ad2"
    "d21ad4d019d5cd18d7ca18d9c818dbc518ddc218dec018e0bd19e2bb19e3b91a"
    "e4b61ce6b41de7b21fe9af20eaac22ebaa25eca727eea42aefa12cf09e2ff19b"
    "32f29835f39438f4913cf58e3ff68a43f78746f8844af8804ef97d52fa7a55fa"
    "7659fb735dfc6f61fc6c65fd6969fd666dfe6271fe5f75fe5c79fe597dff5680"
    "ff5384ff5188ff4e8bff4b8fff4992ff4796fe4499fe429cfe409ffd3fa1fd3d"
    "a4fc3ca7fc3aa9fb39acfb38affa37b1f936b4f836b7f735b9f635bcf534bef4"
    "34c1f334c3f134c6f034c8ef34cbed34cdec34d0ea34d2e935d4e735d7e535d9"
    "e436dbe236dde037dfdf37e1dd37e3db38e5d938e7d739e9d539ebd339ecd13a"
    "eecf3aefcd3af1cb3af2c93af4c73af5c53af6c33af7c13af8be39f9bc39faba"
    "39fbb838fbb637fcb336fcb136fdae35fdac34fea933fea732fea431fea130fe"
    "9e2ffe9b2dfe992cfe962bfe932afe9029fd8d27fd8a26fc8725fc8423fb8122"
    "fb7e21fa7b1ff9781ef9751df8721cf76f1af66c19f56918f46617f36315f260"
    "14f15d13f05b12ef5811ed5510ec530feb500eea4e0de84b0ce7490ce5470be4"
    "450ae2430ae14109df3f08dd3d08dc3b07da3907d83706d63506d43305d23105"
    "d02f05ce2d04cc2b04ca2a04c82803c52603c32503c12302be2102bc2002b91e"
    "02b71d02b41b01b21a01af1801ac1701a91601a71401a41301a112019e10019b"
    "0f01980e01950d01920b018e0a018b09028808028507028106027e05027a0403"),
    np.uint8).reshape(256, 3)

# cv2.circle(img, center, 3, color, -1): per row offset dy, the columns
# dx0..dx1 it fills.
DISC3 = ((-3, 0, 0), (-2, -2, 2), (-1, -2, 2), (0, -3, 3), (1, -2, 2),
         (2, -2, 2), (3, 0, 0))


def _sanitize(path: str) -> str:
    return path.replace("/", "_").replace("\\", "_")


def draw_disc(vis: np.ndarray, x: int, y: int, rgb) -> None:
    """Fill DISC3 at (x, y) in the (H, W, 3) image `vis`, clipped."""
    h, w = vis.shape[:2]
    for dy, dx0, dx1 in DISC3:
        yy = y + dy
        x0, x1 = max(x + dx0, 0), min(x + dx1, w - 1)
        if 0 <= yy < h and x0 <= x1:
            vis[yy, x0:x1 + 1] = rgb


class ArtifactViewer(Viewer):
    def __init__(self, out_dir: str, image_every: int = 10,
                 max_images: int = 200):
        self.out_dir = out_dir
        self.image_every = max(1, image_every)
        self.max_images = max_images
        self._frame = 0
        self._n_images = 0
        self._poses = {}
        os.makedirs(os.path.join(out_dir, "frames"), exist_ok=True)

    def initialize(self) -> bool:
        return True

    def set_frame(self, frame_id: int, timestamp_ns: int) -> None:
        self._frame = int(frame_id)
        with open(os.path.join(self.out_dir, "poses.json"), "w") as f:
            json.dump(dict(self._poses), f)

    # ---- images ----
    def _want_image(self) -> bool:
        return (self._frame % self.image_every == 0
                and self._n_images < self.max_images)

    def _frame_png(self, path: str, img: np.ndarray) -> None:
        png.write_png(os.path.join(self.out_dir, "frames",
                                   f"{_sanitize(path)}_{self._frame:06d}.png"),
                      img)
        self._n_images += 1

    def _write_image(self, path: str, img: np.ndarray) -> None:
        self._frame_png(path, np.clip(img, 0, 255).astype(np.uint8))

    def log_image_raw(self, path: str, img: np.ndarray) -> None:
        if self._want_image():
            self._write_image(path, np.asarray(img))

    def log_image_equalized(self, path: str, img: np.ndarray) -> None:
        img = np.asarray(img, dtype=np.float32)
        lo, hi = img.min(), img.max()
        self.log_image_raw(path, (img - lo) / max(hi - lo, 1e-6) * 255.0)

    def log_image_with_features(self, path: str, img: np.ndarray,
                                pts: np.ndarray) -> None:
        self.log_image_with_features_colored(
            path, img, pts, np.arange(len(pts)))

    def log_image_with_features_colored(self, path: str, img: np.ndarray,
                                        pts: np.ndarray,
                                        ids: np.ndarray) -> None:
        if not self._want_image():
            return
        gray = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
        vis = np.repeat(gray[..., None], 3, axis=2)
        for (x, y), fid in zip(np.asarray(pts), np.asarray(ids)):
            draw_disc(vis, int(round(x)), int(round(y)),
                      get_feature_color(int(fid)))
        self._frame_png(path, vis)

    # ---- geometry ----
    def log_pose(self, path: str, T_W_B: np.ndarray) -> None:
        self._poses[_sanitize(path)] = np.asarray(T_W_B, dtype=float).tolist()

    def log_camera_frustum(self, path: str, T_W_C: np.ndarray,
                           intrinsics, image_size) -> None:
        self.log_pose(path, T_W_C)

    def log_points(self, path: str, pts: np.ndarray) -> None:
        self.log_points_colored(path, pts, np.arange(len(pts)))

    def log_points_colored(self, path: str, pts: np.ndarray,
                           ids: np.ndarray) -> None:
        pts = np.asarray(pts)
        keep = np.linalg.norm(pts, axis=1) < 300.0  # ref rerun.rs:298-306
        pts = pts[keep]
        ids = np.asarray(ids)[keep]
        with open(os.path.join(self.out_dir,
                               f"{_sanitize(path)}.ply"), "w") as f:
            f.write("ply\nformat ascii 1.0\n"
                    f"element vertex {len(pts)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\n"
                    "property uchar blue\nend_header\n")
            for p, fid in zip(pts, ids):
                r, g, b = get_feature_color(int(fid))
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")

    # --- feature-tracker debug surface (ref feature_tracker/src/viewer.rs:6-97)

    def log_labeled_points(self, path: str, uv: np.ndarray, labels) -> None:
        fname = os.path.join(self.out_dir, f"{_sanitize(path)}_labels.txt")
        with open(fname, "a") as f:
            # +0.5: pixel-center convention (ref log_feature_points).
            for (x, y), lab in zip(np.asarray(uv), labels):
                f.write(f"{self._frame} {x + 0.5:.2f} {y + 0.5:.2f} {lab}\n")

    def log_pyramid(self, path: str, pyramid) -> None:
        if not self._want_image():
            return
        for i, level in enumerate(pyramid):
            self._write_image(f"{path}_level{i}", np.asarray(level))

    def log_float_map(self, path: str, arr: np.ndarray) -> None:
        if not self._want_image():
            return
        a = np.asarray(arr, dtype=np.float32)
        lo, hi = float(a.min()), float(a.max())
        u8 = ((a - lo) / max(hi - lo, 1e-9) * 255.0).astype(np.uint8)
        self._frame_png(path, TURBO_RGB[u8])

    def log_trajectory(self, path: str, positions: np.ndarray) -> None:
        positions = np.asarray(positions)
        with open(os.path.join(self.out_dir, "trajectory.txt"), "w") as f:
            for p in positions:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        self._write_traj_svg(positions)

    def _write_traj_svg(self, positions: np.ndarray) -> None:
        """Top-down (x, y) polyline, auto-scaled into a 800x800 viewport."""
        if len(positions) < 2:
            return
        xy = positions[:, :2]
        lo = xy.min(axis=0)
        span = np.maximum(xy.max(axis=0) - lo, 1e-6)
        s = 760.0 / span.max()
        pts = (xy - lo) * s + 20.0
        path_d = " ".join(f"{'M' if i == 0 else 'L'}{x:.1f},{800 - y:.1f}"
                          for i, (x, y) in enumerate(pts))
        svg = (f'<svg xmlns="http://www.w3.org/2000/svg" width="800" '
               f'height="800"><rect width="800" height="800" fill="#111"/>'
               f'<path d="{path_d}" stroke="#ff8c00" stroke-width="2" '
               f'fill="none"/><circle cx="{pts[0][0]:.1f}" '
               f'cy="{800 - pts[0][1]:.1f}" r="5" fill="#0f0"/>'
               f'<circle cx="{pts[-1][0]:.1f}" cy="{800 - pts[-1][1]:.1f}" '
               f'r="5" fill="#f00"/></svg>')
        with open(os.path.join(self.out_dir, "trajectory.svg"), "w") as f:
            f.write(svg)
