"""Trajectory export (TUM format) and ATE evaluation.

The port's own copy of rsvio_tpu/utils/trajectory.py (numpy only; the port
imports nothing of the JAX package): TUM save / load, timestamp
association, Umeyama alignment, ATE RMSE and the 4Seasons GNSS readers,
with the same file formats and numbers.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw) — TUM file ordering."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    return np.array([qx, qy, qz, qw])


def save_tum(path: str, timestamps_ns: Sequence[int], poses: Sequence[np.ndarray]):
    """Write a TUM-format trajectory: `t x y z qx qy qz qw` per line,
    timestamps in seconds."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, T in zip(timestamps_ns, poses):
            T = np.asarray(T, dtype=np.float64)
            q = rot_to_quat_np(T[:3, :3])
            t = T[:3, 3]
            f.write(f"{ts * 1e-9:.9f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def load_tum(path: str):
    """Load a TUM-format trajectory -> (timestamps_s (N,), positions (N,3),
    quaternions xyzw (N,4))."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) < 8:
                continue
            ts.append(vals[0])
            pos.append(vals[1:4])
            quat.append(vals[4:8])
    return np.asarray(ts), np.asarray(pos), np.asarray(quat)


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Associate two timestamp arrays by nearest neighbor within max_dt.
    Returns (idx_a, idx_b)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best, bestd = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(ts_b):
                d = abs(ts_b[k] - t)
                if d <= bestd:
                    best, bestd = k, d
        if best >= 0:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, dtype=int), np.asarray(ib, dtype=int)


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """SE(3) (optionally Sim(3)) alignment y ≈ s R x + t via Umeyama's method.
    x, y: (N, 3). Returns (s, R, t)."""
    mu_x = x.mean(axis=0)
    mu_y = y.mean(axis=0)
    xc = x - mu_x
    yc = y - mu_y
    cov = yc.T @ xc / x.shape[0]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc ** 2).sum() / x.shape[0]
        s = float(np.trace(np.diag(d) @ S) / var_x)
    else:
        s = 1.0
    t = mu_y - s * R @ mu_x
    return s, R, t


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, with_scale: bool = False):
    """SE3-aligned absolute trajectory error RMSE (meters). est/gt: (N,3),
    already associated."""
    s, R, t = umeyama_alignment(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    err = np.linalg.norm(aligned - gt_pos, axis=1)
    return float(np.sqrt((err ** 2).mean())), aligned


def load_gnss_poses(path: str):
    """Parse a 4Seasons `GNSSPoses.txt` ground-truth file.

    Format (comma-separated, `#` comments): per line
    `frame_ts_ns, tx, ty, tz, qx, qy, qz, qw[, scale_gnss_to_metric, ...]`.
    The optional 9th column is the GNSS-to-metric scale; trailing flag
    columns are ignored. The reference never parses this file (its
    trajectory path is a stub, ref src/datasets/euroc_player.rs:316-323);
    this enables the ATE north-star metric on 4Seasons (SURVEY.md §6).

    Returns (timestamps_ns (N,) int64, positions (N,3), quats xyzw (N,4)),
    positions already multiplied by the per-line scale when present.
    """
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.replace(",", " ").split()
            if len(vals) < 8:
                continue
            nums = [float(v) for v in vals[:9]] if len(vals) >= 9 else \
                [float(v) for v in vals[:8]] + [1.0]
            scale = nums[8] if nums[8] > 0 else 1.0
            ts.append(int(float(vals[0])))
            pos.append([nums[1] * scale, nums[2] * scale, nums[3] * scale])
            quat.append(nums[4:8])
    return (np.asarray(ts, dtype=np.int64), np.asarray(pos),
            np.asarray(quat))


def gnss_to_tum(src: str, dst: str):
    """Convert 4Seasons GNSSPoses.txt to a TUM-format trajectory file
    (`t[s] x y z qx qy qz qw`), usable directly with evaluate_ate()."""
    ts, pos, quat = load_gnss_poses(src)
    with open(dst, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p, q in zip(ts, pos, quat):
            f.write(f"{t * 1e-9:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
    return len(ts)


def evaluate_ate(est_file: str, gt_file: str, max_dt: float = 0.02,
                 with_scale: bool = False):
    """ATE between a TUM-format estimate and ground truth file."""
    ts_e, pos_e, _ = load_tum(est_file)
    ts_g, pos_g, _ = load_tum(gt_file)
    ia, ib = associate(ts_e, ts_g, max_dt)
    if len(ia) < 3:
        raise ValueError(f"only {len(ia)} associations between {est_file} and {gt_file}")
    rmse, _ = ate_rmse(pos_e[ia], pos_g[ib], with_scale)
    return rmse, len(ia)
