"""The plain reference: what the scene's exact geometry and the
benchmark's own IMU samples say each answer of the program should be.

numpy only, in float64. It imports nothing of the program and takes
nothing the program made but the answers it judges (poses, velocities,
window, map, feature positions, preintegrations) and, for the
preintegration, the bias point the program stored with it.

Every comparison is made between quantities that do not depend on the
estimator's choice of world frame: motion between two frames of a stream,
poses inside the window relative to its newest keyframe, landmarks
brought into the scene's frame through the frame's own pose, velocity in
the body frame.
"""

from __future__ import annotations

import numpy as np

from . import scene


def inv(T):
    Ti = np.zeros_like(T)
    R = T[..., :3, :3]
    Rt = np.swapaxes(R, -1, -2)
    Ti[..., :3, :3] = Rt
    Ti[..., :3, 3] = -(Rt @ T[..., :3, 3][..., None])[..., 0]
    Ti[..., 3, 3] = 1.0
    return Ti


def rot_angle(R):
    """The angle of rotation R, from its skew part and its trace: accurate
    near 0, where the arccos of the trace alone reads the float32 rounding
    of R as half a milliradian."""
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    return np.arctan2(np.linalg.norm(w, axis=-1) / 2.0, c)


def rel_errors(T_est_a, T_est_b, T_gt_a, T_gt_b):
    """Translation (m) and rotation (rad) error of the motion a -> b."""
    e = inv(T_est_a) @ T_est_b
    g = inv(T_gt_a) @ T_gt_b
    dt = np.linalg.norm(e[..., :3, 3] - g[..., :3, 3], axis=-1)
    dr = rot_angle(np.swapaxes(e[..., :3, :3], -1, -2) @ g[..., :3, :3])
    return dt, dr


def motion_errors(poses_est, poses_gt):
    """Frame-to-frame motion errors of one stream: (n-1,) m and rad."""
    return rel_errors(poses_est[:-1], poses_est[1:], poses_gt[:-1],
                      poses_gt[1:])


def span_errors(poses_est, poses_gt, span: int, min_path: float = 0.05):
    """Relative pose error over `span` frames, as a share of the path the
    body flew over them (spans shorter than min_path m are left out)."""
    if len(poses_est) <= span:
        return np.zeros(0)
    dt, _ = rel_errors(poses_est[:-span], poses_est[span:],
                       poses_gt[:-span], poses_gt[span:])
    step = np.linalg.norm(np.diff(poses_gt[:, :3, 3], axis=0), axis=-1)
    c = np.concatenate([[0.0], np.cumsum(step)])
    path = c[span:] - c[:-span]
    keep = path >= min_path
    return dt[keep] / path[keep]


def velocity_errors(poses_est, vel_est, poses_gt, vel_gt):
    """|v_B(est) - v_B(gt)| (m/s), velocities in the body frame."""
    vb_e = (np.swapaxes(poses_est[:, :3, :3], -1, -2)
            @ vel_est[..., None])[..., 0]
    vb_g = (np.swapaxes(poses_gt[:, :3, :3], -1, -2)
            @ vel_gt[..., None])[..., 0]
    return np.linalg.norm(vb_e - vb_g, axis=-1)


def window_errors(kf_T_est, kf_T_gt):
    """Errors (m, rad) of each window keyframe's pose relative to the
    newest, oldest first (the newest itself left out)."""
    n = len(kf_T_est)
    return rel_errors(kf_T_est[:-1], np.repeat(kf_T_est[-1:], n - 1, 0),
                      kf_T_gt[:-1], np.repeat(kf_T_gt[-1:], n - 1, 0))


def plane_distances(lm_est, T_est, T_gt, plane: scene.Plane):
    """Distance (m) of each landmark from the scene's plane, the landmark
    carried into the scene's frame by the frame's own pose (T_gt T_est^-1),
    which takes the estimator's drift out."""
    A = T_gt @ inv(T_est)
    X = lm_est @ A[:3, :3].T + A[:3, 3]
    return np.abs((X - plane.X0) @ plane.n)


def plane_map(rig: scene.Rig, plane: scene.Plane, uv, cam_a: int,
              T_a, cam_b: int, T_b):
    """Where pixels uv (n, 2) of camera cam_a at body pose T_a see the plane
    from camera cam_b at body pose T_b: the true correspondence."""
    Ta = T_a @ rig.T_B_C[cam_a]
    Tb = T_b @ rig.T_B_C[cam_b]
    xy = scene.unproject(rig.params[cam_a], np.asarray(uv, float))
    d = np.concatenate([xy, np.ones_like(xy[:, :1])], 1) @ Ta[:3, :3].T
    o = Ta[:3, 3]
    s = ((plane.X0 - o) @ plane.n) / (d @ plane.n)
    X = o + s[:, None] * d
    Pc = (X - Tb[:3, 3]) @ Tb[:3, :3]
    return scene.project(rig.params[cam_b], Pc)


def track_errors(rig, plane, prev, table, T_gt_prev, T_gt):
    """Pixel errors of the front end against the true correspondences:
    temporal (each track alive before and after the step, its left
    position carried from the previous frame) and stereo (each live
    feature's right position against its left one). Also the tracks born
    this frame."""
    same = prev["alive"] & table["alive"] & (prev["fid"] == table["fid"])
    t_err = np.zeros(0)
    if same.any():
        pred = plane_map(rig, plane, prev["pos0"][same], 0, T_gt_prev, 0,
                         T_gt)
        t_err = np.linalg.norm(pred - table["pos0"][same], axis=1)
    alive = table["alive"]
    s_err = np.zeros(0)
    if alive.any():
        pred = plane_map(rig, plane, table["pos0"][alive], 0, T_gt, 1, T_gt)
        s_err = np.linalg.norm(pred - table["pos1"][alive], axis=1)
    born = int((alive & ~np.isin(table["fid"], prev["fid"][prev["alive"]]))
               .sum())
    return t_err, s_err, born


def so3_exp(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * K @ K)


def preintegrate(gyro, accel, dts, bg, ba):
    """The mean of IMU preintegration over an interval's samples, at the
    bias point (bg, ba): dR, dv, dp in the first body frame, each sample's
    rate and force held over its dt (Forster et al., TRO 2017, eq. 33)."""
    dR = np.eye(3)
    dv = np.zeros(3)
    dp = np.zeros(3)
    for w, a, dt in zip(np.asarray(gyro, float), np.asarray(accel, float),
                        np.asarray(dts, float)):
        a_w = dR @ (a - ba)
        dp = dp + dv * dt + 0.5 * a_w * dt * dt
        dv = dv + a_w * dt
        dR = dR @ so3_exp((w - bg) * dt)
    return dR, dv, dp


def percentile(x, q):
    x = np.asarray(x, float)
    return float(np.percentile(x, q)) if x.size else float("nan")
