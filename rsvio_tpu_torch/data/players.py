"""Dataset players: manifest parsing and image loading for EuRoC, TUM-VI,
4Seasons and TartanAir, with a background prefetcher feeding the device.

Port of rsvio_tpu/data/players.py with the same manifests, paths and frame
order:
  * EuRoC / TUM-VI: timestamps from ``mav0/cam0/data.csv`` (``#``, header
    and non-digit rows skipped), grayscale PNGs under
    ``mav0/cam{0,1}/data/``, the IMU csv ``mav0/imu0/data.csv``, ground
    truth ``mav0/state_groundtruth_estimate0/data.csv``;
  * 4Seasons: ``times.txt`` (whitespace-split, ``<ts>.png``), images under
    ``undistorted_images/cam{0,1}/``, ground truth ``GNSSPoses.txt``;
  * TartanAir (mono): ``image_left/*.png`` in name order, at most 800.

Images are read by ``data.png`` (no OpenCV). ``prefetch_frames`` decodes on
a background thread and hands out each image also as a uint8 CPU tensor,
with ``pin=True`` in a fresh page-locked (pinned) buffer, so the player
loop uploads it with ``non_blocking=True`` and without a host sync.
PyTorch's caching host allocator hands a pinned block out again only after
the copies recorded on it have finished, so no buffer is reused while its
upload may still be in flight.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from . import png


@dataclass
class FrameData:
    """One stereo frame in host memory. `left` / `right` are (H, W) float32
    from ``load_frame``, uint8 from ``prefetch_frames``, which also fills
    `tensors`: the (left, right) uint8 CPU tensors (pinned when asked)."""
    timestamp_ns: int
    left: np.ndarray
    right: np.ndarray
    tensors: Optional[tuple] = None


@dataclass
class ImuSample:
    """IMU record (ref src/datasets/mod.rs:21-26)."""
    timestamp_ns: int
    gyro: np.ndarray   # (3,)
    accel: np.ndarray  # (3,)


def _digit_rows(path: str):
    """csv rows whose first field is a number (no ``#``, no header)."""
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#") or \
                    not row[0].strip().isdigit():
                continue
            yield row


class _StereoPlayer:
    """Frame loading shared by the stereo layouts: subclasses give
    `entries` and `frame_paths`."""

    def __len__(self):
        return len(self.entries)

    def load_frame(self, i: int, as_uint8: bool = False) -> FrameData:
        ts, lp, rp = self.frame_paths(i)
        left, right = png.read_gray_u8(lp), png.read_gray_u8(rp)
        if not as_uint8:
            left, right = left.astype(np.float32), right.astype(np.float32)
        return FrameData(ts, left, right)


class EurocPlayer(_StereoPlayer):
    """EuRoC MAV dataset layout (also the TUM-VI mav0 export layout)."""

    cam0_dir = "mav0/cam0"
    cam1_dir = "mav0/cam1"
    imu_dir = "mav0/imu0"

    def __init__(self, dataset_path: str):
        self.root = dataset_path
        self.entries = self._load_manifest()

    def _load_manifest(self) -> List[Tuple[int, str]]:
        """(ref euroc_player.rs:178-210: skip header and # lines)."""
        path = os.path.join(self.root, self.cam0_dir, "data.csv")
        return sorted((int(row[0]), row[1].strip())
                      for row in _digit_rows(path))

    def frame_paths(self, i: int) -> Tuple[int, str, str]:
        ts, fname = self.entries[i]
        return (ts,
                os.path.join(self.root, self.cam0_dir, "data", fname),
                os.path.join(self.root, self.cam1_dir, "data", fname))

    def load_imu(self) -> List[ImuSample]:
        """IMU csv: ts, gx, gy, gz, ax, ay, az (EuRoC layout)."""
        path = os.path.join(self.root, self.imu_dir, "data.csv")
        if not os.path.exists(path):
            return []
        out = []
        for row in _digit_rows(path):
            vals = [float(v) for v in row[1:7]]
            out.append(ImuSample(int(row[0]), np.asarray(vals[:3]),
                                 np.asarray(vals[3:])))
        return out

    def ground_truth_file(self) -> Optional[str]:
        p = os.path.join(self.root, "mav0", "state_groundtruth_estimate0",
                         "data.csv")
        return p if os.path.exists(p) else None


class TUMVIPlayer(EurocPlayer):
    """TUM-VI uses the same mav0 layout (ref tum_vi_player.rs is a near-clone
    of euroc_player.rs)."""


class FourSeasonsPlayer(_StereoPlayer):
    """4Seasons: times.txt manifest, undistorted_images/cam{0,1}/<ts>.png
    (ref fourseasons_player.rs:179-216)."""

    def __init__(self, dataset_path: str):
        self.root = dataset_path
        self.entries = self._load_manifest()

    def _load_manifest(self) -> List[Tuple[int, str]]:
        entries = []
        with open(os.path.join(self.root, "times.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts = line.split()[0]
                entries.append((int(ts), f"{ts}.png"))
        return sorted(entries)

    def frame_paths(self, i: int) -> Tuple[int, str, str]:
        ts, fname = self.entries[i]
        return (ts,
                os.path.join(self.root, "undistorted_images", "cam0", fname),
                os.path.join(self.root, "undistorted_images", "cam1", fname))

    def load_imu(self) -> List[ImuSample]:
        return []

    def ground_truth_file(self) -> Optional[str]:
        p = os.path.join(self.root, "GNSSPoses.txt")
        return p if os.path.exists(p) else None


class TartanAirPlayer:
    """TartanAir mono sequences: image_left/*.png ordered by filename, at
    most 800 (ref feature_tracker/src/players/tartanair_player.rs:24-62)."""

    MAX_FRAMES = 800

    def __init__(self, dataset_path: str):
        self.root = dataset_path
        img_dir = os.path.join(dataset_path, "image_left")
        names = sorted(n for n in os.listdir(img_dir)
                       if n.endswith(".png"))[: self.MAX_FRAMES]
        self.entries = list(enumerate(names))

    def __len__(self):
        return len(self.entries)

    def load_frame(self, i: int, as_uint8: bool = False) -> FrameData:
        idx, name = self.entries[i]
        img = png.read_gray_u8(os.path.join(self.root, "image_left", name))
        if not as_uint8:
            img = img.astype(np.float32)
        # mono: the right slot mirrors the left (consumers use left only)
        return FrameData(int(idx * 1e8), img, img)


def _with_tensors(frame: FrameData, pin: bool) -> FrameData:
    import torch

    def t(a):
        x = torch.from_numpy(a)
        return x.pin_memory() if pin else x

    left = t(frame.left)
    right = left if frame.right is frame.left else t(frame.right)
    frame.tensors = (left, right)
    return frame


def prefetch_frames(player, start: int = 0, end: Optional[int] = None,
                    depth: int = 4, pin: bool = False,
                    decode_ms: Optional[list] = None) -> Iterator[FrameData]:
    """Frames start..end-1 in order, as uint8 with their tensors, decoded
    on a background thread up to `depth` ahead of the consumer. `pin`: the
    tensors in pinned memory (needs CUDA). `decode_ms`: a list the thread
    appends each frame's load time to. A load error is raised to the
    consumer at the frame it hit."""
    end = len(player) if end is None else min(end, len(player))
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for i in range(start, end):
                t0 = time.perf_counter()
                frame = _with_tensors(player.load_frame(i, as_uint8=True),
                                      pin)
                if decode_ms is not None:
                    decode_ms.append((time.perf_counter() - t0) * 1e3)
                if not put(frame):
                    return
        except Exception as e:  # surface decode errors to the consumer
            put(e)
        put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join()
