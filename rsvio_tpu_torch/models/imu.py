"""IMU preintegration between keyframes, with first-order bias Jacobians,
and the 15-dim residual joining consecutive VIO states.

Port of rsvio_tpu/models/imu.py (Forster et al., on-manifold
preintegration): fixed-capacity sample buffers with validity masks, an
Euler update per sample, covariance propagation in [theta, v, p] block
form. Conventions as there: gravity in the world frame g = (0, 0, -9.81),
states (T_W_B, v_W, b_g, b_a).

``preintegrate`` is JAX's ``lax.scan`` as a loop on the host over the
samples, each step a few dozen small tensor ops. The parts of a step that
do not depend on the running carry (the per-sample rotation increment,
bias-corrected samples, their skew matrices, the noise block) are computed
for the whole buffer at once first. A masked sample is an exact no-op (its
dt is 0 and every carry entry is kept by a select), so the loop may stop
after the last sample that can be valid: ``n_steps``, which the caller
knows on the host, gives the same bits as the whole buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie

GRAVITY = 9.81


class ImuParams(NamedTuple):
    gyro_noise: float = 1.7e-4     # rad/s/sqrt(Hz)  (EuRoC MAV defaults)
    accel_noise: float = 2.0e-3    # m/s^2/sqrt(Hz)
    gyro_bias_walk: float = 1.9e-5
    accel_bias_walk: float = 3.0e-3


class Preintegrated(NamedTuple):
    """Preintegrated IMU measurement over one keyframe interval (leading
    batch dims allowed: the window holds (W-1,) of them)."""
    dR: torch.Tensor        # (3,3) rotation delta body_i -> body_j
    dv: torch.Tensor        # (3,) velocity delta in body_i
    dp: torch.Tensor        # (3,) position delta in body_i
    dt: torch.Tensor        # () total integration time
    dR_dbg: torch.Tensor    # (3,3) first-order bias Jacobians
    dv_dbg: torch.Tensor
    dv_dba: torch.Tensor
    dp_dbg: torch.Tensor
    dp_dba: torch.Tensor
    cov: torch.Tensor       # (9,9) covariance of [dR, dv, dp] errors
    bias_gyro: torch.Tensor   # (3,) linearization-point biases
    bias_accel: torch.Tensor


def preintegrate(gyro, accel, dts, mask, bias_gyro, bias_accel,
                 params: ImuParams = ImuParams(),
                 n_steps: int = None) -> Preintegrated:
    """Preintegrate a masked sample buffer.

    gyro, accel (S, 3) raw samples; dts (S,) intervals (s); mask (S,) bool,
    padding samples contribute nothing; bias_gyro, bias_accel (3,) biases
    at the linearization point. n_steps: a host int >= 1 + the index of
    the last sample that may be valid (default S); the samples after it
    are not visited, which changes no bit of the result.
    """
    S = gyro.shape[0]
    n = S if n_steps is None else max(0, min(int(n_steps), S))
    dtype, dev = gyro.dtype, gyro.device
    I3 = torch.eye(3, dtype=dtype, device=dev)

    # Carry-independent parts, for the whole buffer.
    dt_all = torch.where(mask, dts, torch.zeros_like(dts))
    w_c = gyro - bias_gyro
    a_c = accel - bias_accel
    dRk_all = lie.so3_exp(w_c * dt_all[:, None])              # (S,3,3)
    a_hat_all = lie.so3_hat(a_c)                              # (S,3,3)
    sg = params.gyro_noise ** 2
    sa = params.accel_noise ** 2
    d = dt_all[:, None]
    q = torch.cat([(sg * d).expand(S, 3), (sa * d).expand(S, 3),
                   (sa * d * d * d / 3.0).expand(S, 3)], dim=1)
    Q_all = torch.diag_embed(q)                               # (S,9,9)
    Z3 = torch.zeros((S, 3, 3), dtype=dtype, device=dev)

    dR = I3
    dv = torch.zeros(3, dtype=dtype, device=dev)
    dp = torch.zeros(3, dtype=dtype, device=dev)
    J = torch.zeros((5, 3, 3), dtype=dtype, device=dev)
    cov = torch.zeros((9, 9), dtype=dtype, device=dev)
    t = torch.zeros((), dtype=dtype, device=dev)
    for k in range(n):
        m, dt = mask[k], dt_all[k]
        dRk, a_hat = dRk_all[k], a_hat_all[k]
        dR_dbg, dv_dbg, dv_dba, dp_dbg, dp_dba = J
        a_rot = dR @ a_c[k]
        dp_new = dp + dv * dt + 0.5 * a_rot * dt * dt
        dv_new = dv + a_rot * dt
        dR_new = dR @ dRk
        # Bias Jacobians (right Jacobian ~ I at 200 Hz sample angles).
        dRa = dR @ a_hat
        dRa_J = dRa @ dR_dbg
        J_new = torch.stack([
            dRk.T @ dR_dbg - I3 * dt,
            dv_dbg - dRa_J * dt,
            dv_dba - dR * dt,
            dp_dbg + dv_dbg * dt - 0.5 * dRa_J * dt * dt,
            dp_dba + dv_dba * dt - 0.5 * dR * dt * dt])
        # Covariance propagation, block form [theta, v, p].
        A = torch.cat([
            torch.cat([dRk.T, Z3[k], Z3[k]], dim=1),
            torch.cat([-dRa * dt, I3, Z3[k]], dim=1),
            torch.cat([-0.5 * dRa * dt * dt, I3 * dt, I3], dim=1)], dim=0)
        cov_new = A @ cov @ A.T + Q_all[k]
        dR = torch.where(m, dR_new, dR)
        dv = torch.where(m, dv_new, dv)
        dp = torch.where(m, dp_new, dp)
        J = torch.where(m, J_new, J)
        cov = torch.where(m, cov_new, cov)
        t = t + dt
    return Preintegrated(dR=dR, dv=dv, dp=dp, dt=t, dR_dbg=J[0],
                         dv_dbg=J[1], dv_dba=J[2], dp_dbg=J[3],
                         dp_dba=J[4], cov=cov, bias_gyro=bias_gyro,
                         bias_accel=bias_accel)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def imu_residual(pre: Preintegrated, T_W_Bi, v_i, bg_i, ba_i,
                 T_W_Bj, v_j, bg_j, ba_j):
    """15-dim residual [r_dR, r_dv, r_dp, r_bg, r_ba] between consecutive
    VIO states, first-order bias-corrected around the preintegration
    point. Every argument may carry the same leading batch dims."""
    dtype = pre.dR.dtype
    g = torch.eye(3, dtype=dtype, device=pre.dR.device)[2] * -GRAVITY
    R_i, p_i = T_W_Bi[..., :3, :3], T_W_Bi[..., :3, 3]
    R_j, p_j = T_W_Bj[..., :3, :3], T_W_Bj[..., :3, 3]
    dt = pre.dt[..., None]
    dbg = bg_i - pre.bias_gyro
    dba = ba_i - pre.bias_accel
    dR_corr = pre.dR @ lie.so3_exp(_mv(pre.dR_dbg, dbg))
    dv_corr = pre.dv + _mv(pre.dv_dbg, dbg) + _mv(pre.dv_dba, dba)
    dp_corr = pre.dp + _mv(pre.dp_dbg, dbg) + _mv(pre.dp_dba, dba)
    R_iT = R_i.transpose(-1, -2)
    r_dR = lie.so3_log(dR_corr.transpose(-1, -2) @ (R_iT @ R_j))
    r_dv = _mv(R_iT, v_j - v_i - g * dt) - dv_corr
    r_dp = _mv(R_iT, p_j - p_i - v_i * dt - 0.5 * g * dt * dt) - dp_corr
    return torch.cat([r_dR, r_dv, r_dp, bg_j - bg_i, ba_j - ba_i], dim=-1)


def attitude_from_gravity(accel_mean):
    """Initial attitude R_W_B (3,3) from the mean specific force (3,): the
    minimal rotation taking u = a/|a| onto world +z (a static body measures
    R_W_B^T (0, 0, +g)); yaw stays zero. u ~ -z (upside down) rotates pi
    about x."""
    dtype, dev = accel_mean.dtype, accel_mean.device
    u = accel_mean / torch.clamp(torch.linalg.vector_norm(accel_mean),
                                 min=1e-9)
    eye = torch.eye(3, dtype=dtype, device=dev)
    z, x_axis = eye[2], eye[0]
    v = torch.linalg.cross(u, z)
    s = torch.linalg.vector_norm(v)
    c = torch.dot(u, z)
    axis = torch.where(s > 1e-8, v / torch.clamp(s, min=1e-12), x_axis)
    return lie.so3_exp(axis * torch.atan2(s, c))


def split_samples_by_keyframes(imu_ts_ns, kf_ts_ns, max_per_interval: int):
    """Host: bucket IMU samples into per-keyframe-interval fixed buffers.
    Returns index / mask arrays (n_intervals, max_per_interval) (numpy)."""
    imu_ts = np.asarray(imu_ts_ns)
    kf_ts = np.asarray(kf_ts_ns)
    n_int = len(kf_ts) - 1
    idx = np.zeros((n_int, max_per_interval), dtype=np.int64)
    mask = np.zeros((n_int, max_per_interval), dtype=bool)
    for i in range(n_int):
        lo, hi = kf_ts[i], kf_ts[i + 1]
        sel = np.nonzero((imu_ts >= lo) & (imu_ts < hi))[0][:max_per_interval]
        idx[i, :len(sel)] = sel
        mask[i, :len(sel)] = True
    return idx, mask
