"""Write small recorded datasets in the layouts the players read.

Used by the tests and by chip_smoke.py to build EuRoC / TUM-VI (``mav0``),
4Seasons and TartanAir trees from frames held in memory, with PNGs written
by ``data.png.write_png`` (no OpenCV). The rows of each image cycle through
all five PNG filter types, so a reader meets every one of them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from . import png


def _u16(img: np.ndarray, seed: int) -> np.ndarray:
    """uint8 image -> uint16 with it as the high byte and seeded noise as
    the low byte: a 16-bit file whose 8-bit reading is `img`."""
    low = np.random.default_rng(seed).integers(0, 256, img.shape)
    return (img.astype(np.uint16) << 8) | low.astype(np.uint16)


def _write(path: str, img: np.ndarray, k: int, depth: int) -> None:
    if img.dtype != np.uint8:
        raise ValueError(f"frames must be uint8, got {img.dtype}")
    png.write_png(path, _u16(img, k) if depth == 16 else img,
                  filters=png.cycle_filters(img.shape[0], k))


def _write_all(jobs) -> None:
    """_write each (path, img, k, depth), a few at a time (zlib and numpy
    release the GIL)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        for f in [ex.submit(_write, *job) for job in jobs]:
            f.result()


def write_euroc(root: str, frames: Sequence, stamps_ns: Sequence[int],
                depth: int = 8, gt_positions: Optional[np.ndarray] = None,
                imu: Optional[np.ndarray] = None) -> str:
    """A ``mav0`` tree: cam0 / cam1 PNGs (`depth` 8 or 16 bits) and their
    ``data.csv``; ``imu0/data.csv`` from `imu` rows (ts_ns, gx, gy, gz, ax,
    ay, az); ``state_groundtruth_estimate0/data.csv`` from `gt_positions`
    (one per frame, stamped in ns, identity orientation). Returns root."""
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
    rows = ["#timestamp [ns],filename"]
    jobs = []
    for k, ((left, right), ts) in enumerate(zip(frames, stamps_ns)):
        for cam, img, s in (("cam0", left, 2 * k), ("cam1", right, 2 * k + 1)):
            jobs.append((os.path.join(root, "mav0", cam, "data", f"{ts}.png"),
                         img, s, depth))
        rows.append(f"{ts},{ts}.png")
    _write_all(jobs)
    for cam in ("cam0", "cam1"):
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    if imu is not None:
        os.makedirs(os.path.join(root, "mav0", "imu0"), exist_ok=True)
        with open(os.path.join(root, "mav0", "imu0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
            for r in imu:
                f.write(f"{int(r[0])}," + ",".join(f"{v:.9g}" for v in r[1:7])
                        + "\n")
    if gt_positions is not None:
        d = os.path.join(root, "mav0", "state_groundtruth_estimate0")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "data.csv"), "w") as f:
            f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
            for ts, p in zip(stamps_ns, gt_positions):
                f.write(f"{ts},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},1,0,0,0\n")
    return root


def write_four_seasons(root: str, frames: Sequence, stamps_ns: Sequence[int],
                       gt_positions: Optional[np.ndarray] = None) -> str:
    """A 4Seasons tree: ``times.txt``, ``undistorted_images/cam{0,1}/
    <ts>.png`` and, from `gt_positions`, ``GNSSPoses.txt`` (scale 1).
    Returns root."""
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "undistorted_images", cam),
                    exist_ok=True)
    lines, jobs = [], []
    for k, ((left, right), ts) in enumerate(zip(frames, stamps_ns)):
        for cam, img, s in (("cam0", left, 2 * k), ("cam1", right, 2 * k + 1)):
            jobs.append((os.path.join(root, "undistorted_images", cam,
                                      f"{ts}.png"), img, s, 8))
        lines.append(f"{ts} {ts * 1e-9:.9f} 0.01")
    _write_all(jobs)
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if gt_positions is not None:
        with open(os.path.join(root, "GNSSPoses.txt"), "w") as f:
            f.write("# frame_ts, tx, ty, tz, qx, qy, qz, qw, scale\n")
            for ts, p in zip(stamps_ns, gt_positions):
                f.write(f"{ts},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},0,0,0,1,1\n")
    return root


def write_tartanair(root: str, images: Sequence[np.ndarray]) -> str:
    """A TartanAir mono tree: ``image_left/<k:06d>_left.png``. Returns
    root."""
    os.makedirs(os.path.join(root, "image_left"), exist_ok=True)
    _write_all([(os.path.join(root, "image_left", f"{k:06d}_left.png"), img,
                 k, 8) for k, img in enumerate(images)])
    return root
