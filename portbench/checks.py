"""Whether what the timed path produced is correct: every answer judged
against the plain reference (reference.py), each number beside its limit.

Numbers (a run computes all of them; the cell's limits file names those it
compares, each with its limit, and the rest are printed as information):

  motion_mm, motion_mrad   99th percentile over every frame of every stream
                           of the error of the motion since the frame
                           before (the frame's PnP pose and, on keyframes,
                           the window solve), translation and rotation
  span_pct                 95th percentile of the relative pose error over
                           `span_frames` frames, as a share of the path
  window_mm, window_mrad   largest error of a window keyframe's pose
                           relative to the window's newest, over the
                           sampled frames with a full window
  plane_mm                 95th percentile of the sampled maps' landmark
                           distances from the scene's plane
  track_px, stereo_px      95th percentile of the front end's pixel errors
                           against the true correspondences (temporal
                           tracks; left-right matches, births among them)
  vel_mps                  VIO: 95th percentile of the body-frame velocity
                           error over every frame
  preint_drot_urad, preint_dv_mmps, preint_dp_um
                           VIO: largest gap between the window's stored
                           preintegrations and the reference's over the same
                           samples at the stored bias point
  bias_gyro_mradps, bias_accel_mmps2
                           VIO: the window's newest bias estimates against
                           the scene's constant biases (largest over the
                           sampled frames)

A frame whose pose is not finite, or a stream that completed no frame in
the window, is a failed answer and makes the run not correct.
"""

from __future__ import annotations

import numpy as np

from . import reference as ref
from . import scene


def judge(streams, loop: scene.Loop, rig: scene.Rig, plane: scene.Plane,
          window: int, span: int, kind: str, imu_cfg=None):
    """streams: per stream a dict with start, poses (n, 4, 4) est, vel
    (VIO), kf (n,) bool, first (index of the first window frame), snaps
    (host snapshots) and, for VIO, buffers (its IMU buffers). Each number
    is taken over the frames of all streams together. Returns (numbers,
    attempted, failed)."""
    motion_t, motion_r, spans, vel = [], [], [], []
    win_t, win_r, plane_d, trk, ste = [], [], [], [], []
    pre_r, pre_v, pre_p, b_g, b_a = [], [], [], [], []
    attempted = failed = 0
    for s in streams:
        n = len(s["poses"])
        t = (s["start"] + np.arange(n)) / loop.fps
        gt = loop.poses(t, rig)
        first = s["first"]
        est = s["poses"].astype(np.float64)
        attempted += n - first
        bad = ~np.isfinite(est[first:]).all(axis=(1, 2))
        failed += int(bad.sum())
        if n - first <= 0:
            failed += 1
            continue
        if bad.any():
            continue
        lo = max(first - 1, 0)
        dt, dr = ref.motion_errors(est[lo:], gt[lo:])
        motion_t.append(dt)
        motion_r.append(dr)
        spans.append(ref.span_errors(est[first:], gt[first:], span))
        if kind == "vio":
            vel.append(ref.velocity_errors(est[first:],
                                           s["vel"][first:].astype(float),
                                           gt[first:],
                                           loop.velocity(t[first:])))
        kf_idx = np.flatnonzero(s["kf"])
        for snap in s["snaps"]:
            k = snap["k"]
            e_t, e_s, _ = ref.track_errors(rig, plane, snap["prev"],
                                           snap["table"], gt[k - 1], gt[k])
            trk.append(e_t)
            ste.append(e_s)
            if int(snap["kf_count"]) < window:
                continue
            kfs = kf_idx[kf_idx <= k][-window:]
            if len(kfs) < window:
                continue
            wt, wr = ref.window_errors(snap["kf_T_W_B"].astype(float),
                                       gt[kfs])
            win_t.append(wt.max())
            win_r.append(wr.max())
            ok = snap["lm_fid"] >= 0
            if ok.any():
                plane_d.append(ref.plane_distances(
                    snap["lm"][ok].astype(float),
                    snap["T_W_B"].astype(float), gt[k], plane))
            if kind != "vio":
                continue
            b_g.append(np.linalg.norm(snap["kf_bg"][-1]
                                      - np.asarray(imu_cfg["gyro_bias"])))
            b_a.append(np.linalg.norm(snap["kf_ba"][-1]
                                      - np.asarray(imu_cfg["accel_bias"])))
            g, a, d, m = s["buffers"]
            p = snap["preint"]
            for i in range(window - 1):
                if not snap["preint_valid"][i]:
                    continue
                fr = np.arange(kfs[i] + 1, kfs[i + 1] + 1)
                if fr[0] < 1:       # the stream's first frame has no samples
                    continue
                j = (s["start"] + fr) % loop.frames
                mm = m[j]
                dR, dv, dp = ref.preintegrate(
                    g[j][mm], a[j][mm], d[j][mm],
                    p["bias_gyro"][i].astype(float),
                    p["bias_accel"][i].astype(float))
                pre_r.append(ref.rot_angle(dR.T @ p["dR"][i]))
                pre_v.append(np.linalg.norm(dv - p["dv"][i]))
                pre_p.append(np.linalg.norm(dp - p["dp"][i]))

    def cat(xs):
        return np.concatenate(xs) if xs else np.zeros(0)

    def top(xs, scale):
        return float(np.max(xs) * scale) if len(xs) else float("nan")

    nums = {
        "motion_mm": ref.percentile(cat(motion_t), 99) * 1e3,
        "motion_mrad": ref.percentile(cat(motion_r), 99) * 1e3,
        "span_pct": ref.percentile(cat(spans), 95) * 100.0,
        "window_mm": top(win_t, 1e3),
        "window_mrad": top(win_r, 1e3),
        "plane_mm": ref.percentile(cat(plane_d), 95) * 1e3,
        "track_px": ref.percentile(cat(trk), 95),
        "stereo_px": ref.percentile(cat(ste), 95),
    }
    if kind == "vio":
        nums.update({
            "vel_mps": ref.percentile(cat(vel), 95),
            "preint_drot_urad": top(pre_r, 1e6),
            "preint_dv_mmps": top(pre_v, 1e3),
            "preint_dp_um": top(pre_p, 1e6),
            "bias_gyro_mradps": top(b_g, 1e3),
            "bias_accel_mmps2": top(b_a, 1e3),
        })
    return nums, attempted, failed


def verdict(nums: dict, limits: dict, failed: int):
    """(correct, checks): each compared number with its limit; a number
    that could not be computed (nan) fails its limit."""
    checks = {}
    ok = failed == 0
    for name, limit in limits.items():
        v = nums.get(name, float("nan"))
        good = bool(np.isfinite(v) and v <= limit)
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
