"""Visual-inertial estimator: the VO step extended with IMU preintegration,
velocity and bias state, IMU-aided motion prediction and the joint
visual-inertial window solver.

Port of rsvio_tpu/models/estimator_vio.py. The per-frame step takes a
fixed-capacity IMU sample buffer (the samples since the previous frame,
masked) besides the stereo images:
  * the frame's samples are preintegrated at the current bias for the
    motion prediction, and appended to the keyframe interval's sample
    buffer (device-resident, ``interval_buf`` slots);
  * the IMU prediction seeds the shared motion stage (``run_motion``: the
    RANSAC gate's hypotheses, the PnP polish, its motion prior and its
    failure fallback);
  * on a keyframe the interval's samples are preintegrated again at the
    current bias and join the window as an IMU factor; the window is solved
    by models.vio_ba (15-dim states, Schur-eliminated landmarks), with a
    15-dim marginalization prior when ``base.use_marginalization``.

Control flow as in models/estimator.py: the step is cut at JAX's
``lax.cond``s (``pnp_ready`` in run_motion, ``is_kf`` and ``full_now``)
into segments (``VIOSegments``: F, the front stage and the RANSAC
excision; on a keyframe P, the keyframe stage's prologue with the
interval's preintegration; K, the rest), each branch a host argument;
every other choice (``have_samples``, the interval's validity, the desert
factors, the prior update) is a device select. Each preintegration loop
runs to a host bound. Two steps run the segments:

- ``make_vio_estimator_step`` runs them eagerly and reads each branch from
  the device on the syncs the VO step has; the interval's sample count,
  its loop's bound, comes in the same device-to-host read as ``is_kf``.
- ``make_compiled_vio_estimator_step``, the counterpart of the JAX
  package's jitted step, replays CUDA graphs of the segments' variants.
  It mirrors frame_id, kf_count and buf_count on the host (the frame's
  valid-sample count comes from the host mask) and reads only ``is_kf``:
  one blocking read a frame (``CompiledVIOStep``). Its loops run to the
  counts rounded up to powers of two (``loop_bound``), which gives the
  same bits.

IMU input. ``gyro``, ``accel``, ``dts``, ``imu_mask`` may be host arrays
(numpy or CPU tensors): the step then knows from the host mask how many
samples can be valid (its preintegration loop stops there) and uploads the
four arrays as ONE pinned, non-blocking copy (a pageable upload is a
sync). Given device tensors, it loops over the whole buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import profiling
from ..ops import lie, projection, pyramid
from ..utils import graphs as graph_mod
from ..utils.precision import pin_fp32
from . import imu as imu_mod
from . import vio_ba
from . import estimator as est_mod
from .estimator import (CameraRig, EstimatorConfig, FrameOutput, _count,
                        _triangulate_new, _undistort_table, excise_outliers,
                        gumbel_draws, reprojection_outliers, scene_flow_gate)
from .frontend import frontend_step, init_table
from .imu import ImuParams, Preintegrated
from .marginalization import MargPrior, empty_prior


class VIOEstimatorConfig(NamedTuple):
    """Same fields and defaults as the JAX VIOEstimatorConfig."""
    base: EstimatorConfig = EstimatorConfig()
    imu_buf: int = 64                    # max IMU samples per frame
    # Samples buffered per keyframe interval (re-preintegrated at the
    # current bias when the interval closes); 512 covers > 2.5 s at 200 Hz.
    interval_buf: int = 512
    imu_params: ImuParams = ImuParams()
    vio: vio_ba.VIOBAConfig = vio_ba.VIOBAConfig()


def _empty_preint(dtype=torch.float32, device="cuda") -> Preintegrated:
    I3 = torch.eye(3, dtype=dtype, device=device)
    Z3 = torch.zeros((3, 3), dtype=dtype, device=device)
    z = torch.zeros(3, dtype=dtype, device=device)
    return Preintegrated(dR=I3, dv=z, dp=z.clone(),
                         dt=torch.zeros((), dtype=dtype, device=device),
                         dR_dbg=Z3, dv_dbg=Z3.clone(), dv_dba=Z3.clone(),
                         dp_dbg=Z3.clone(), dp_dba=Z3.clone(),
                         cov=torch.zeros((9, 9), dtype=dtype, device=device),
                         bias_gyro=z.clone(), bias_accel=z.clone())


def _chain_preint(a: Preintegrated, b: Preintegrated) -> Preintegrated:
    """Compose two consecutive preintegrations (same bias point): dR =
    dRa dRb, dv = dva + dRa dvb, dp = dpa + dva dtb + dRa dpb, Jacobians
    and covariance to first order."""
    dR = a.dR @ b.dR
    dv = a.dv + a.dR @ b.dv
    dp = a.dp + a.dv * b.dt + a.dR @ b.dp
    dR_dbg = b.dR.T @ a.dR_dbg + b.dR_dbg
    hat_bdv = lie.so3_hat(b.dv)
    hat_bdp = lie.so3_hat(b.dp)
    dv_dbg = a.dv_dbg + a.dR @ b.dv_dbg - a.dR @ hat_bdv @ a.dR_dbg
    dv_dba = a.dv_dba + a.dR @ b.dv_dba
    dp_dbg = (a.dp_dbg + a.dv_dbg * b.dt + a.dR @ b.dp_dbg
              - a.dR @ hat_bdp @ a.dR_dbg)
    dp_dba = a.dp_dba + a.dv_dba * b.dt + a.dR @ b.dp_dba
    I3 = torch.eye(3, dtype=a.cov.dtype, device=a.cov.device)
    Z3 = torch.zeros_like(I3)
    A = torch.cat([
        torch.cat([b.dR.T, Z3, Z3], dim=1),
        torch.cat([-a.dR @ hat_bdv, I3, Z3], dim=1),
        torch.cat([-a.dR @ hat_bdp, I3 * b.dt, I3], dim=1)], dim=0)
    cov = A @ a.cov @ A.T + b.cov
    return Preintegrated(dR=dR, dv=dv, dp=dp, dt=a.dt + b.dt,
                         dR_dbg=dR_dbg, dv_dbg=dv_dbg, dv_dba=dv_dba,
                         dp_dbg=dp_dbg, dp_dba=dp_dba, cov=cov,
                         bias_gyro=a.bias_gyro, bias_accel=a.bias_accel)


class VIOEstimatorState(NamedTuple):
    """Same fields, in the same order, as the JAX VIOEstimatorState (the
    checkpoint's leaf order). The optional fields at the end are allocated
    as in JAX: the scene-flow memories with dynamic_flow_thresh > 0,
    lm_birth / health_ema with the RANSAC gate, kf_bias_alpha with the
    desert bias stiffness (_bias_desert_on)."""
    table: object
    pyr0: tuple
    pyr1: tuple
    kf_T_W_B: torch.Tensor      # (W,4,4) window, oldest -> newest
    kf_vel: torch.Tensor        # (W,3)
    kf_bg: torch.Tensor         # (W,3)
    kf_ba: torch.Tensor         # (W,3)
    kf_count: torch.Tensor
    obs: torch.Tensor
    obs_mask: torch.Tensor
    obs_fid: torch.Tensor
    obs_w: torch.Tensor         # (W,N)
    kf_preint: Preintegrated    # (W-1,) per window interval
    kf_preint_valid: torch.Tensor  # (W-1,)
    buf_gyro: torch.Tensor      # (B,3) samples since the last keyframe
    buf_accel: torch.Tensor     # (B,3)
    buf_dts: torch.Tensor       # (B,)
    buf_count: torch.Tensor     # () int32
    lm: torch.Tensor
    lm_fid: torch.Tensor
    marg_prior: MargPrior       # 15-dim blocks
    T_W_B: torch.Tensor
    vel: torch.Tensor           # (3,)
    bg: torch.Tensor
    ba: torch.Tensor
    last_kf_T_W_B: torch.Tensor
    frame_id: torch.Tensor
    tri_prev: torch.Tensor = None
    tri_prev_fid: torch.Tensor = None
    flow_acc: torch.Tensor = None
    flow_n: torch.Tensor = None
    lm_birth: torch.Tensor = None
    health_ema: torch.Tensor = None
    kf_bias_alpha: torch.Tensor = None   # (W-1,)


def _bias_desert_on(cfg: VIOEstimatorConfig) -> bool:
    """Health-gated bias stiffness engaged: both desert weights set and the
    RANSAC consensus gate as the health signal."""
    return (cfg.vio.bias_gyro_weight_desert > 0.0
            and cfg.vio.bias_accel_weight_desert > 0.0
            and cfg.base.pnp.ransac_hypotheses > 0)


def init_vio_state(cfg: VIOEstimatorConfig, dtype=torch.float32,
                   device="cuda") -> VIOEstimatorState:
    b = cfg.base
    N = b.frontend.capacity
    W = b.window_size
    shapes = pyramid.pyramid_shapes(tuple(b.image_shape),
                                    b.frontend.klt.levels)
    pyr = tuple(torch.zeros(s, dtype=dtype, device=device) for s in shapes)
    eye = torch.eye(4, dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    fl = dict(dtype=dtype, device=device)
    kf_pre = Preintegrated(*(x.expand((W - 1,) + x.shape).clone()
                             for x in _empty_preint(dtype, device)))
    return VIOEstimatorState(
        table=init_table(N, dtype, device),
        pyr0=pyr, pyr1=tuple(p.clone() for p in pyr),
        kf_T_W_B=eye.expand(W, 4, 4).clone(),
        kf_vel=torch.zeros((W, 3), **fl), kf_bg=torch.zeros((W, 3), **fl),
        kf_ba=torch.zeros((W, 3), **fl),
        kf_count=torch.zeros((), **i32),
        obs=torch.zeros((W, 2, N, 2), **fl),
        obs_mask=torch.zeros((W, 2, N), dtype=torch.bool, device=device),
        obs_fid=torch.full((W, N), -1, **i32),
        obs_w=torch.ones((W, N), **fl),
        kf_preint=kf_pre,
        kf_preint_valid=torch.zeros((W - 1,), dtype=torch.bool,
                                    device=device),
        buf_gyro=torch.zeros((cfg.interval_buf, 3), **fl),
        buf_accel=torch.zeros((cfg.interval_buf, 3), **fl),
        buf_dts=torch.zeros((cfg.interval_buf,), **fl),
        buf_count=torch.zeros((), **i32),
        lm=torch.zeros((N, 3), **fl),
        lm_fid=torch.full((N,), -1, **i32),
        marg_prior=empty_prior(W, vio_ba.D, dtype, device),
        T_W_B=eye.clone(), vel=torch.zeros(3, **fl),
        bg=torch.zeros(3, **fl), ba=torch.zeros(3, **fl),
        last_kf_T_W_B=eye.clone(),
        frame_id=torch.zeros((), **i32),
        **(dict(tri_prev=torch.zeros((N, 3), **fl),
                tri_prev_fid=torch.full((N,), -1, **i32),
                flow_acc=torch.zeros((N, 2), **fl),
                flow_n=torch.zeros((N,), **i32))
           if b.dynamic_flow_thresh > 0 else {}),
        **(dict(lm_birth=torch.zeros((N, 3), **fl),
                health_ema=torch.ones((), **fl))
           if b.pnp.ransac_hypotheses > 0 else {}),
        **(dict(kf_bias_alpha=torch.zeros((W - 1,), **fl))
           if _bias_desert_on(cfg) else {}),
    )


def quasi_static_check(gyro, accel, gyro_std_max: float = 0.05,
                       accel_std_max: float = 0.3,
                       gravity_tol: float = 0.05):
    """Whether an IMU sample window is quasi-static, i.e. usable for the
    gravity-aligned bootstrap: per-axis gyro std <= gyro_std_max (rad/s),
    per-axis accel std <= accel_std_max (m/s^2), |mean accel| within
    gravity_tol (relative) of 9.81. Host numpy; returns (ok, info)."""
    gyro = np.asarray(gyro, np.float64)
    accel = np.asarray(accel, np.float64)
    gyro_std = float(np.max(gyro.std(axis=0))) if len(gyro) > 1 else 0.0
    accel_std = float(np.max(accel.std(axis=0))) if len(accel) > 1 else 0.0
    acc_norm = float(np.linalg.norm(accel.mean(axis=0)))
    ok = (gyro_std <= gyro_std_max and accel_std <= accel_std_max
          and abs(acc_norm - imu_mod.GRAVITY)
          <= gravity_tol * imu_mod.GRAVITY)
    return ok, {"gyro_std": gyro_std, "accel_std": accel_std,
                "accel_norm": acc_norm}


def initialize_vio_state(cfg: VIOEstimatorConfig, gyro, accel,
                         dtype=torch.float32,
                         device="cuda") -> VIOEstimatorState:
    """Gravity-aligned static bootstrap from a quasi-static sample window
    (gyro, accel (S, 3), S >= 1, host arrays): the attitude aligning the
    mean specific force with world +z (yaw free), the gyro bias at the mean
    rate, velocity and accel bias zero. Frame 0 then anchors a
    gravity-consistent world gauge."""
    state = init_vio_state(cfg, dtype, device)
    gyro = torch.as_tensor(np.asarray(gyro), dtype=dtype, device=device)
    accel = torch.as_tensor(np.asarray(accel), dtype=dtype, device=device)
    R0 = imu_mod.attitude_from_gravity(accel.mean(dim=0))
    T0 = lie.se3_from_rt(R0, torch.zeros(3, dtype=dtype, device=device))
    return state._replace(T_W_B=T0, last_kf_T_W_B=T0.clone(),
                          bg=gyro.mean(dim=0))


def _imu_predict(T_W_B, vel, pre: Preintegrated):
    """Propagate pose and velocity through a preintegrated interval."""
    g = torch.eye(3, dtype=T_W_B.dtype, device=T_W_B.device)[2] \
        * -imu_mod.GRAVITY
    R, p, dt = T_W_B[:3, :3], T_W_B[:3, 3], pre.dt
    p_new = p + vel * dt + 0.5 * g * dt * dt + R @ pre.dp
    v_new = vel + g * dt + R @ pre.dv
    return lie.se3_from_rt(R @ pre.dR, p_new), v_new


class VIOFrontOut(NamedTuple):
    """Outputs of the front stage (pyramids, IMU buffering, frontend,
    motion)."""
    pyr0: tuple
    pyr1: tuple
    table: object
    fstats: dict
    obs_cur: torch.Tensor
    obs_cur_mask: torch.Tensor
    buf_gyro: torch.Tensor
    buf_accel: torch.Tensor
    buf_dts: torch.Tensor
    buf_count: torch.Tensor
    v_pred: torch.Tensor
    mo: est_mod.MotionOut


class VIOKFPrep(NamedTuple):
    """Keyframe prologue outputs: the visual window pieces plus velocity
    and bias states and the re-preintegrated IMU intervals."""
    table: object
    kf_T: torch.Tensor
    kf_v: torch.Tensor
    kf_bg: torch.Tensor
    kf_ba: torch.Tensor
    kf_count: torch.Tensor
    obs_w: torch.Tensor
    obs_m: torch.Tensor
    obs_f: torch.Tensor
    obs_wt: torch.Tensor
    kf_preint: Preintegrated
    kf_preint_valid: torch.Tensor
    lm: torch.Tensor
    lm_fid: torch.Tensor
    eff_mask: torch.Tensor
    lm_valid: torch.Tensor
    tri_mem: tuple
    n_dyn: torch.Tensor
    lm_birth: torch.Tensor
    full_now: torch.Tensor
    will_evict: torch.Tensor
    bias_alpha: torch.Tensor = None


class VIOStages(NamedTuple):
    front: callable
    excise: callable
    kf_pre: callable
    kf_post: callable
    ba_solve: callable


def _build_vio_stages(cfg: VIOEstimatorConfig, probe=None,
                      window_solvers=None) -> VIOStages:
    """The per-frame VIO step as named stage functions (JAX's
    _build_vio_stages). stage_front takes, beyond JAX's arguments, the
    host's pnp_ready and the gate's draws (est_mod.read_motion_branch or
    the compiled step's mirror), and stage_front and stage_kf_pre the host
    bound of their preintegration loops."""
    b = cfg.base
    W = b.window_size
    B_cap = cfg.interval_buf
    solvers = vio_ba if window_solvers is None else window_solvers
    est_mod.check_config(b)
    if ((cfg.vio.bias_gyro_weight_desert > 0.0
         or cfg.vio.bias_accel_weight_desert > 0.0)
            and not _bias_desert_on(cfg)):
        # Refuse half-configured desert stiffness rather than ignore it.
        raise NotImplementedError(
            "bias_*_weight_desert requires BOTH desert weights set and the "
            "RANSAC consensus gate (pnp.ransac_hypotheses > 0) as the "
            "health signal")
    desert = _bias_desert_on(cfg)

    def stage_front(state: VIOEstimatorState, rig: CameraRig, img0, img1,
                    gyro, accel, dts, imu_mask, ready: bool, gumbel,
                    n_steps: int = None) -> VIOFrontOut:
        pyr0 = pyramid.build_pyramid(img0, b.frontend.klt.levels)
        pyr1 = pyramid.build_pyramid(img1, b.frontend.klt.levels)

        # This frame's samples: preintegrated for the prediction, and
        # appended to the interval buffer at buf_count (masked samples go
        # to a padding slot; overflow lands on the last slot and saturates
        # buf_count, which makes the interval invalid).
        frame_pre = imu_mod.preintegrate(gyro, accel, dts, imu_mask,
                                         state.bg, state.ba, cfg.imu_params,
                                         n_steps=n_steps)
        have_samples = imu_mask.any()
        m32 = imu_mask.to(torch.int32)
        tgt = state.buf_count + torch.cumsum(m32, 0) - 1
        tgt = torch.where(imu_mask, torch.clamp(tgt, 0, B_cap - 1),
                          torch.full_like(tgt, B_cap)).to(torch.int64)

        def buf_scatter(buf, vals):
            padded = torch.cat([buf, buf[-1:]], dim=0)
            return padded.index_put((tgt,), vals.to(buf.dtype))[:B_cap]

        buf_gyro = buf_scatter(state.buf_gyro, gyro)
        buf_accel = buf_scatter(state.buf_accel, accel)
        buf_dts = buf_scatter(state.buf_dts, dts)
        buf_count = torch.clamp(state.buf_count + m32.sum(dtype=torch.int32),
                                max=B_cap)

        table_in = state.table._replace(
            alive=state.table.alive & (state.frame_id > 0))
        table, fstats = frontend_step(table_in, state.pyr0, state.pyr1,
                                      pyr0, pyr1, b.frontend)
        obs_cur, obs_cur_mask = _undistort_table(b, rig, table)

        # The IMU prediction seeds, anchors and backs up the motion stage.
        T_pred, v_pred = _imu_predict(state.T_W_B, state.vel, frame_pre)
        T_pred = torch.where(have_samples, T_pred, state.T_W_B)
        v_pred = torch.where(have_samples, v_pred, state.vel)
        mo = est_mod.run_motion(
            b, rig, table, obs_cur, obs_cur_mask, state.lm, state.lm_fid,
            state.lm_birth, state.kf_count, state.last_kf_T_W_B,
            T_pred=T_pred, T_gate_seed=T_pred, T_prior=T_pred,
            T_fallback=T_pred, ready=ready, gumbel=gumbel,
            # The permanent birth weight (no age ramp in VIO).
            obs_w_slots=(table.w if b.use_obs_weights else None),
            cv_bound_check=False, health_prev=state.health_ema)
        return VIOFrontOut(pyr0=pyr0, pyr1=pyr1, table=table, fstats=fstats,
                           obs_cur=obs_cur, obs_cur_mask=obs_cur_mask,
                           buf_gyro=buf_gyro, buf_accel=buf_accel,
                           buf_dts=buf_dts, buf_count=buf_count,
                           v_pred=v_pred, mo=mo)

    def stage_kf_pre(state: VIOEstimatorState, rig: CameraRig, table,
                     obs_cur, obs_cur_mask, buf_gyro, buf_accel, buf_dts,
                     buf_count, T_cur, v_cur, health=1.0,
                     n_buf: int = None) -> VIOKFPrep:
        """Triangulation, scene-flow gate, window and interval rolls, the
        interval re-preintegrated at the current bias (n_buf: its sample
        count on the host, the loop's bound), birth refinement. `state`
        carries the excised lm_fid."""
        dev = T_cur.device
        window_full = state.kf_count >= W
        lm, lm_fid, born, tri_all, tri_ok = _triangulate_new(
            rig, T_cur, obs_cur, table, state.lm, state.lm_fid)
        tri_mem = (state.tri_prev, state.tri_prev_fid, state.flow_acc,
                   state.flow_n)
        n_dyn = torch.zeros((), dtype=torch.int32, device=dev)
        if b.dynamic_flow_thresh > 0:
            kill_dyn, tri_mem, n_dyn = scene_flow_gate(
                b, rig, T_cur, obs_cur, obs_cur_mask, table, tri_all,
                tri_ok, *tri_mem)
            table = table._replace(alive=table.alive & ~kill_dyn)
            lm_fid = torch.where(kill_dyn, torch.full_like(lm_fid, -1),
                                 lm_fid)
            _count(probe, "flow_tracked", tri_mem[3] > 0)
        obs_cur_mask_eff = obs_cur_mask & table.alive[None, :]
        lm_birth = (torch.where(born[:, None], tri_all, state.lm_birth)
                    if state.lm_birth is not None else None)
        ins = torch.clamp(state.kf_count, max=W - 1).to(torch.int64)
        ins1 = ins.reshape(1)

        def roll(arr, full=window_full):
            return torch.where(full, torch.roll(arr, -1, dims=0), arr)

        def roll_insert(arr, row):
            return roll(arr).index_copy(0, ins1, row[None].to(arr.dtype))

        kf_T = roll_insert(state.kf_T_W_B, T_cur)
        kf_v = roll_insert(state.kf_vel, v_cur)
        kf_bg = roll_insert(state.kf_bg, state.bg)
        kf_ba_ = roll_insert(state.kf_ba, state.ba)
        obs_w = roll_insert(state.obs, obs_cur)
        obs_m = roll_insert(state.obs_mask, obs_cur_mask_eff)
        obs_f = roll_insert(state.obs_fid, table.fid)
        w_ins = table.w
        if b.vision_weight_adaptive:
            # Desert coasting: low-consensus frames bring less visual
            # information, so the IMU factors and priors hold the pose.
            w_ins = w_ins * torch.clamp(torch.as_tensor(health, dtype=w_ins.dtype,
                                                        device=dev),
                                        min=b.health_floor)
        obs_wt = roll_insert(state.obs_w, w_ins)

        # Interval i joins keyframes i and i+1: the buffered samples
        # re-preintegrated at the current bias land at slot ins-1 (valid
        # when a previous keyframe exists and the buffer did not overflow).
        buf_mask = torch.arange(B_cap, device=dev) < buf_count
        run_pre = imu_mod.preintegrate(buf_gyro, buf_accel, buf_dts,
                                       buf_mask, state.bg, state.ba,
                                       cfg.imu_params, n_steps=n_buf)
        run_valid = (buf_count > 0) & (buf_count < B_cap)
        slot = torch.clamp(ins - 1, 0, W - 2).reshape(1)
        has_prev = ins > 0

        def set_slot(arr, v):
            arr = roll(arr)
            old = arr.index_select(0, slot)[0]
            return arr.index_copy(0, slot, torch.where(has_prev, v, old)[None])

        kf_pre = Preintegrated(*(set_slot(a, v) for a, v in
                                 zip(state.kf_preint, run_pre)))
        kf_pv = set_slot(state.kf_preint_valid, run_valid)
        bias_alpha = state.kf_bias_alpha
        if desert:
            # Desert factor of the interval closing here, on the health
            # band of the other adaptive defenses.
            h_eff = torch.clamp(torch.as_tensor(
                health, dtype=bias_alpha.dtype, device=dev), 0.0, 1.0)
            a_new = torch.clamp(
                (b.health_f_hi - h_eff)
                / max(b.health_f_hi - b.health_f_lo, 1e-6), 0.0, 1.0)
            bias_alpha = set_slot(bias_alpha, a_new)
        kf_count = torch.clamp(state.kf_count + 1, max=W)
        full_now = kf_count >= (2 if b.track_before_full else W)
        eff_mask = obs_m & (obs_f == table.fid[None, :])[:, None, :]
        kf_valid = torch.arange(W, device=dev) < kf_count
        eff_mask = eff_mask & kf_valid[:, None, None]
        lm_valid = (lm_fid == table.fid) & (lm_fid >= 0)
        if b.refine_births:
            lm_ref, ok_ref = projection.refine_landmarks(
                rig.T_C_B, lie.se3_inverse(kf_T), lm, obs_w,
                eff_mask & born[None, None, :])
            refined = born & ok_ref
            lm = torch.where(refined[:, None], lm_ref, lm)
            _count(probe, "refined", refined)
        # will_evict only when the next insert rolls the window.
        return VIOKFPrep(table=table, kf_T=kf_T, kf_v=kf_v, kf_bg=kf_bg,
                         kf_ba=kf_ba_, kf_count=kf_count, obs_w=obs_w,
                         obs_m=obs_m, obs_f=obs_f, obs_wt=obs_wt,
                         kf_preint=kf_pre, kf_preint_valid=kf_pv, lm=lm,
                         lm_fid=lm_fid, eff_mask=eff_mask, lm_valid=lm_valid,
                         tri_mem=tri_mem, n_dyn=n_dyn, lm_birth=lm_birth,
                         full_now=full_now, will_evict=kf_count >= W,
                         bias_alpha=bias_alpha)

    def ba_solve(prep: VIOKFPrep, rig: CameraRig, marg_prior):
        """The joint window solve: (VIOState, landmarks, ok, iterations,
        cost, next prior)."""
        ba_w = prep.obs_wt if b.use_obs_weights else None
        # Window-max desert factor: the biases are one chain through the
        # window, so the whole chain is stiffened.
        b_alpha = (prep.bias_alpha.max().expand(prep.bias_alpha.shape)
                   if desert else None)
        st = vio_ba.VIOState(T_W_B=prep.kf_T, vel=prep.kf_v, bg=prep.kf_bg,
                             ba=prep.kf_ba)
        if b.use_marginalization:
            res, new_prior = solvers.solve_vio_ba_marginalized(
                st, rig.T_C_B, prep.lm, prep.obs_w, prep.eff_mask,
                prep.lm_valid, prep.kf_preint, prep.kf_preint_valid,
                marg_prior, prep.will_evict, cfg.vio, obs_weight=ba_w,
                bias_alpha=b_alpha)
            _count(probe, "priors_made", prep.will_evict & res.success)
        else:
            res = solvers.solve_vio_ba(
                st, rig.T_C_B, prep.lm, prep.obs_w, prep.eff_mask,
                prep.lm_valid, prep.kf_preint, prep.kf_preint_valid,
                cfg.vio, obs_weight=ba_w, bias_alpha=b_alpha)
            new_prior = marg_prior
        return (res.state, res.landmarks, res.success, res.iterations,
                res.final_cost, new_prior)

    def stage_kf_post(prep: VIOKFPrep, rig: CameraRig, res_st, res_lm,
                      ba_ok):
        """Accept or reject the solve; optional reprojection culling."""
        kf_T = torch.where(ba_ok, res_st.T_W_B, prep.kf_T)
        kf_v = torch.where(ba_ok, res_st.vel, prep.kf_v)
        kf_bg = torch.where(ba_ok, res_st.bg, prep.kf_bg)
        kf_ba_ = torch.where(ba_ok, res_st.ba, prep.kf_ba)
        lm = torch.where(ba_ok, res_lm, prep.lm)
        lm_fid = prep.lm_fid
        if b.cull_reproj_threshold > 0.0:
            bad = reprojection_outliers(
                rig.T_C_B, kf_T, lm, prep.obs_w, prep.eff_mask,
                prep.lm_valid, b.cull_reproj_threshold ** 2) & ba_ok
            lm_fid = torch.where(bad, torch.full_like(lm_fid, -1), lm_fid)
            _count(probe, "cull_checked", prep.lm_valid & ba_ok)
            _count(probe, "culled", bad)
        return kf_T, kf_v, kf_bg, kf_ba_, lm, lm_fid

    return VIOStages(front=stage_front, excise=excise_outliers,
                     kf_pre=stage_kf_pre, kf_post=stage_kf_post,
                     ba_solve=ba_solve)


class VIOSeg(NamedTuple):
    """Segment F's results: the front stage's outputs, with the feature
    table and this frame's mask after the RANSAC excision (use_kill), and
    the state's lm_fid after it."""
    fr: VIOFrontOut
    lm_fid: torch.Tensor


class VIOSegments(NamedTuple):
    """The VIO step cut at its branch points (JAX's lax.conds on is_kf and
    full_now, and run_motion's on pnp_ready), each branch a host argument,
    and each preintegration loop's bound a host int:
    front(state, rig, img0, img1, gyro, accel, dts, imu_mask, ready, gumbel,
    n_steps) -> VIOSeg (segment F: stage_front, then the excision);
    kf_pre(state, rig, seg, n_buf) -> VIOKFPrep (segment P, on a keyframe:
    stage_kf_pre, whose interval loop runs to n_buf); opt(state, rig, seg,
    prep, solve) -> (state, FrameOutput) (segment K: the rest of the
    keyframe stage for a VIOKFPrep, or the frame without a keyframe for
    prep None). The keyframe stage is cut in two at its loop so that a new
    loop bound is a new variant of the small P alone."""
    front: callable
    kf_pre: callable
    opt: callable


def _build_vio_segments(cfg: VIOEstimatorConfig, vst: VIOStages
                        ) -> VIOSegments:
    b = cfg.base
    W = b.window_size
    use_kill = b.pnp.ransac_hypotheses > 0 and b.pnp_ransac_kill

    def front(state, rig, img0, img1, gyro, accel, dts, imu_mask,
              ready: bool, gumbel, n_steps: int = None) -> VIOSeg:
        fr = vst.front(state, rig, img0, img1, gyro, accel, dts, imu_mask,
                       ready, gumbel, n_steps=n_steps)
        lm_fid = state.lm_fid
        if use_kill:
            table, obs_cur_mask, lm_fid = vst.excise(
                fr.table, fr.obs_cur_mask, state.lm_fid, fr.mo.kill)
            fr = fr._replace(table=table, obs_cur_mask=obs_cur_mask)
        return VIOSeg(fr=fr, lm_fid=lm_fid)

    def kf_pre(state: VIOEstimatorState, rig: CameraRig, seg: VIOSeg,
               n_buf: int = None) -> VIOKFPrep:
        fr, mo = seg.fr, seg.fr.mo
        return vst.kf_pre(state._replace(lm_fid=seg.lm_fid), rig, fr.table,
                          fr.obs_cur, fr.obs_cur_mask, fr.buf_gyro,
                          fr.buf_accel, fr.buf_dts, fr.buf_count, mo.T_cur,
                          fr.v_pred, mo.health, n_buf=n_buf)

    def opt(state: VIOEstimatorState, rig: CameraRig, seg: VIOSeg,
            prep: VIOKFPrep, solve: bool):
        fr, mo = seg.fr, seg.fr.mo
        state = state._replace(lm_fid=seg.lm_fid)
        table = fr.table
        T_cur, v_pred = mo.T_cur, fr.v_pred
        dev, dtype = T_cur.device, T_cur.dtype
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        if prep is not None:
            if solve:
                res_st, res_lm, ba_ok, ba_it, ba_cost, marg_prior = \
                    vst.ba_solve(prep, rig, state.marg_prior)
            else:
                res_st = vio_ba.VIOState(T_W_B=prep.kf_T, vel=prep.kf_v,
                                         bg=prep.kf_bg, ba=prep.kf_ba)
                res_lm = prep.lm
                ba_ok = torch.zeros((), dtype=torch.bool, device=dev)
                ba_it = zero_i
                ba_cost = torch.zeros((), dtype=dtype, device=dev)
                marg_prior = state.marg_prior
            kf_T, kf_v, kf_bg, kf_ba_, lm, lm_fid = vst.kf_post(
                prep, rig, res_st, res_lm, ba_ok)
            newest = (torch.clamp(prep.kf_count, max=W) - 1) \
                .to(torch.int64).reshape(1)

            def last(x):
                return x.index_select(0, newest)[0]

            T_out, v_out, bg_out, ba_out = (last(kf_T), last(kf_v),
                                            last(kf_bg), last(kf_ba_))
            last_kf = T_out
            kf_count, obs_w, obs_m, obs_f, obs_wt = (
                prep.kf_count, prep.obs_w, prep.obs_m, prep.obs_f,
                prep.obs_wt)
            kf_pint, kf_pv = prep.kf_preint, prep.kf_preint_valid
            table = prep.table
            tri_mem, n_dyn, lm_birth = prep.tri_mem, prep.n_dyn, \
                prep.lm_birth
            bias_alpha = prep.bias_alpha
            # The interval sample buffer restarts.
            buf_count = torch.zeros_like(fr.buf_count)
        else:
            kf_T, kf_v, kf_bg, kf_ba_ = (state.kf_T_W_B, state.kf_vel,
                                         state.kf_bg, state.kf_ba)
            kf_count, obs_w, obs_m, obs_f, obs_wt = (
                state.kf_count, state.obs, state.obs_mask, state.obs_fid,
                state.obs_w)
            kf_pint, kf_pv = state.kf_preint, state.kf_preint_valid
            lm, lm_fid, lm_birth = state.lm, state.lm_fid, state.lm_birth
            T_out, v_out, bg_out, ba_out = T_cur, v_pred, state.bg, state.ba
            last_kf = state.last_kf_T_W_B
            ba_ok = torch.zeros((), dtype=torch.bool, device=dev)
            ba_it = zero_i
            ba_cost = torch.zeros((), dtype=dtype, device=dev)
            marg_prior = state.marg_prior
            tri_mem = (state.tri_prev, state.tri_prev_fid, state.flow_acc,
                       state.flow_n)
            n_dyn = zero_i
            bias_alpha = state.kf_bias_alpha
            buf_count = fr.buf_count

        new_state = VIOEstimatorState(
            table=table, pyr0=fr.pyr0, pyr1=fr.pyr1,
            kf_T_W_B=kf_T, kf_vel=kf_v, kf_bg=kf_bg, kf_ba=kf_ba_,
            kf_count=kf_count, obs=obs_w, obs_mask=obs_m, obs_fid=obs_f,
            obs_w=obs_wt, kf_preint=kf_pint, kf_preint_valid=kf_pv,
            buf_gyro=fr.buf_gyro, buf_accel=fr.buf_accel,
            buf_dts=fr.buf_dts, buf_count=buf_count,
            lm=lm, lm_fid=lm_fid, marg_prior=marg_prior,
            T_W_B=T_out, vel=v_out, bg=bg_out, ba=ba_out,
            last_kf_T_W_B=last_kf, frame_id=state.frame_id + 1,
            tri_prev=tri_mem[0], tri_prev_fid=tri_mem[1],
            flow_acc=tri_mem[2], flow_n=tri_mem[3], lm_birth=lm_birth,
            health_ema=mo.health if state.health_ema is not None else None,
            kf_bias_alpha=bias_alpha)
        out = FrameOutput(
            T_W_B=T_out, is_keyframe=mo.is_kf, pnp_success=mo.pnp_success,
            ba_success=ba_ok, ba_iterations=ba_it, ba_final_cost=ba_cost,
            n_tracked=fr.fstats["tracked"],
            n_landmarks=((lm_fid == table.fid) & (lm_fid >= 0))
            .to(torch.int32).sum(dtype=torch.int32),
            n_alive=fr.fstats["alive"], pose_ok=mo.pose_ok,
            n_dyn_killed=n_dyn, n_ransac_inliers=mo.n_inliers,
            n_pnp_candidates=mo.n_pnp, health=mo.health)
        return new_state, out

    return VIOSegments(front=front, kf_pre=kf_pre, opt=opt)


def _is_host(*arrs) -> bool:
    return all(not torch.is_tensor(a) or a.device.type == "cpu"
               for a in arrs)


def _imu_host(gyro, accel, dts, imu_mask, dtype):
    """Host IMU arrays packed as one (S, 8) CPU tensor in `dtype` (gyro,
    accel, dts, mask as 0 / 1), with the loop bound n_steps (1 + the last
    set mask index, 0 without one) and the count of set samples."""
    m = np.asarray(imu_mask.cpu() if torch.is_tensor(imu_mask)
                   else imu_mask, dtype=bool)
    n_steps = int(np.flatnonzero(m)[-1]) + 1 if m.any() else 0
    host = torch.cat([torch.as_tensor(np.asarray(
        a.cpu() if torch.is_tensor(a) else a)).reshape(len(m), -1).to(dtype)
        for a in (gyro, accel, dts, imu_mask)], dim=1)
    return host, n_steps, int(m.sum())


def _imu_split(buf):
    """(S, 8) packed IMU buffer -> gyro, accel, dts, mask."""
    return buf[:, :3], buf[:, 3:6], buf[:, 6], buf[:, 7] > 0.5


def _imu_inputs(gyro, accel, dts, imu_mask, dtype, dev):
    """The step's IMU buffer on `dev` in `dtype` and the host bound of the
    preintegration loop (1 + the last set mask index; None where the inputs
    are device tensors). Host inputs go up as one pinned non-blocking
    copy."""
    if _is_host(gyro, accel, dts, imu_mask):
        host, n_steps, _ = _imu_host(gyro, accel, dts, imu_mask, dtype)
        if dev.type == "cuda":
            host = host.pin_memory().to(dev, non_blocking=True)
        return (*_imu_split(host), n_steps)
    return (gyro.to(dev, dtype), accel.to(dev, dtype), dts.to(dev, dtype),
            imu_mask.to(dev), None)


def loop_bound(n: int, cap: int) -> int:
    """A preintegration loop's bound for n samples in the compiled step: n
    rounded up to a power of two, at least 8, at most cap (the buffer's
    length). A masked sample past the last valid one changes no bit of the
    result (models/imu.preintegrate), so any bound >= n gives the bits of
    n; the rounding keeps the number of graph variants small."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


def make_vio_estimator_step(cfg: VIOEstimatorConfig, draws=gumbel_draws,
                            probe=None, window_solvers=None):
    """Build the per-frame VIO step
    (state, rig, img0, img1, gyro (S,3), accel (S,3), dts (S,),
    imu_mask (S,)) -> (state, FrameOutput). Pins full fp32 and validates
    the config when called. `draws` and `probe` as in
    make_estimator_step ("priors_made" counts the marginalized solves that
    produced the next prior). `window_solvers`: an object with
    ``solve_vio_ba`` and ``solve_vio_ba_marginalized`` of models.vio_ba's
    signatures (default models.vio_ba; parallel.dist_estimator passes the
    landmark-sharded ones), and optionally ``counters`` as in
    make_estimator_step.

    The step runs the segments eagerly and reads its branches from the
    device: one read for pnp_ready (with the RANSAC gate, together with
    the frame id that seeds its draws), one for is_kf with the interval's
    sample count (its preintegration loop's bound), one more on a keyframe
    for full_now (make_compiled_vio_estimator_step mirrors them on the
    host instead)."""
    pin_fp32()
    b = cfg.base
    sg = _build_vio_segments(cfg, _build_vio_stages(cfg, probe,
                                                    window_solvers))

    def step(state: VIOEstimatorState, rig: CameraRig, img0, img1,
             gyro, accel, dts, imu_mask):
        dev, dtype = state.T_W_B.device, state.T_W_B.dtype
        gyro, accel, dts, imu_mask, n_steps = _imu_inputs(
            gyro, accel, dts, imu_mask, dtype, dev)
        ready, gumbel = est_mod.read_motion_branch(
            b, state.kf_count, state.frame_id, draws, state.lm.shape[0],
            dtype, dev)
        seg = sg.front(state, rig, img0, img1, gyro, accel, dts, imu_mask,
                       ready, gumbel, n_steps=n_steps)
        # Host branch (JAX: lax.cond on is_kf): one read a frame, which
        # also brings the interval's sample count.
        is_kf, n_buf = torch.stack([seg.fr.mo.is_kf.to(torch.int32),
                                    seg.fr.buf_count]).tolist()
        if not is_kf:
            return sg.opt(state, rig, seg, None, False)
        prep = sg.kf_pre(state, rig, seg, n_buf=n_buf)
        # Host branch (JAX: lax.cond on full_now): one read a keyframe.
        return sg.opt(state, rig, seg, prep,
                      bool(est_mod.full_now(b, state.kf_count)))

    step.segments = sg
    return step


class CompiledVIOStep(est_mod.GraphStep):
    """The per-frame VIO step as CUDA graphs: the port's counterpart of the
    JAX package's jitted VIO step (make_compiled_vio_estimator_step builds
    it; called as step(state, rig, img0, img1, gyro, accel, dts, imu_mask)
    -> (state, FrameOutput) with make_vio_estimator_step's results).

    Segment F (stage_front and the RANSAC excision) has a variant for each
    pnp_ready and bound of the frame's preintegration loop, key
    ("front", ready, bound). On a keyframe segment P (stage_kf_pre) runs a
    variant per bound of the interval's preintegration loop,
    ("kf_pre", bound), then segment K (the rest of the keyframe stage) a
    variant before the window solve engages and one with the solve,
    ("kf", True, solve); a frame without a keyframe runs K's ("kf", False)
    alone. The bounds are loop_bound of the valid samples: at most 4 frame
    bounds up to the 64-slot buffer and 7 interval bounds up to
    interval_buf = 512, where a loop over the whole buffer would replay ~50
    small kernels a slot. Cutting the keyframe stage at its loop keeps the
    solve (~22,000 kernels, ~1 s to run first and capture on an H100) out
    of the variants that a new interval length adds.

    `mirror` holds the next frame's (frame_id, kf_count, buf_count): with
    the frame's valid-sample count from the host mask it gives pnp_ready,
    the draws' seed, the frame's bound, the interval's sample count
    (min(buf_count + n_valid, interval_buf), as the state's) and full_now;
    after a keyframe buf_count is 0. Only is_kf is read from the device
    (GraphStep); the mirror is read from a state the step did not return
    (a first call, a bootstrap, a checkpoint's state), one more read then.

    The IMU buffer goes into a fixed (S, 8) device buffer outside the
    graphs: host arrays through one persistent pinned staging buffer (the
    frame's one blocking read orders its reuse); device tensors with one
    more blocking read a frame, of their valid count and bound (counted in
    `host_reads`). `segments`: the eager step's (make_vio_estimator_step's
    `segments`); `counters` as in GraphStep."""

    def __init__(self, cfg: VIOEstimatorConfig, draws, device,
                 segments: VIOSegments, counters=()):
        super().__init__(cfg.base, draws, device,
                         "make_compiled_vio_estimator_step", counters)
        self.vcfg = cfg
        self._sg = segments
        self._imu = self._imu_host = self._prep = None

    def _stage_imu(self, gyro, accel, dts, imu_mask):
        """The frame's IMU buffer into the fixed device buffer; returns
        (n_steps, n_valid) on the host."""
        dtype = self._in.tree.T_W_B.dtype
        if _is_host(gyro, accel, dts, imu_mask):
            host, n_steps, n_valid = _imu_host(gyro, accel, dts, imu_mask,
                                               dtype)
        else:
            m = imu_mask.to(self.device).reshape(-1)
            host = torch.cat([x.to(self.device, dtype).reshape(len(m), -1)
                              for x in (gyro, accel, dts, m)], dim=1)
            idx = torch.arange(1, len(m) + 1, device=self.device)
            n_valid, n_steps = torch.stack([
                m.to(torch.int64).sum(),
                torch.where(m, idx, torch.zeros_like(idx)).max()]).tolist()
            self.host_reads += 1
        if self._imu is None:
            self._imu = torch.empty(host.shape, dtype=dtype,
                                    device=self.device)
            self._imu_host = torch.empty(host.shape, dtype=dtype,
                                         pin_memory=self.pinned)
        if host.device.type == "cpu":
            self._imu_host.copy_(host)
            host = self._imu_host
        self._imu.copy_(host, non_blocking=True)
        return n_steps, n_valid

    def _front(self, ready: bool, bound: int):
        gate = ready and self.cfg.pnp.ransac_hypotheses > 0

        def fn():
            seg = self._sg.front(self._in.tree, self._rig.tree,
                                 *self._img.tree, *_imu_split(self._imu),
                                 ready, self._gumbel if gate else None,
                                 n_steps=bound)
            self._keep_mid(seg, seg.fr.mo.is_kf)
        return fn

    def _kf_pre(self, bound: int):
        def fn():
            prep = self._sg.kf_pre(self._in.tree, self._rig.tree,
                                   self._mid.tree, n_buf=bound)
            if self._prep is None:
                self._prep = graph_mod.Slab(prep, self.device)
            self._prep.load(prep)
        return fn

    def _opt(self, is_kf: bool, solve: bool):
        def fn():
            self._keep_new(self._sg.opt(
                self._in.tree, self._rig.tree, self._mid.tree,
                self._prep.tree if is_kf else None, solve))
        return fn

    def __call__(self, state: VIOEstimatorState, rig: CameraRig, img0, img1,
                 gyro, accel, dts, imu_mask):
        b, cap = self.cfg, self.vcfg.interval_buf
        with self._step_span() as sp:
            with profiling.span("step.load"):
                if self._load(state, rig, (img0, img1)):
                    kf, fid, buf = torch.stack([
                        state.kf_count.to(torch.int64),
                        state.frame_id.to(torch.int64),
                        state.buf_count.to(torch.int64)]).tolist()
                    self.mirror = (fid, kf, buf)
                n_steps, n_valid = self._stage_imu(gyro, accel, dts,
                                                   imu_mask)
                fid, kf, buf = self.mirror
                ready = bool(est_mod.pnp_ready(b, kf))
                if ready and b.pnp.ransac_hypotheses > 0:
                    self._stage_draws(fid)
            sp.set(frame=fid, ready=ready)
            front = ("front", ready, loop_bound(n_steps, self._imu.shape[0]))
            self._segment(front, self._front(ready, front[2]), "motion")
            is_kf = self._read_is_kf()
            n_buf = min(buf + n_valid, cap)
            pre = None
            solve = is_kf and bool(est_mod.full_now(b, kf))
            sp.set(is_kf=is_kf, solve=solve)
            if is_kf:
                pre = ("kf_pre", loop_bound(n_buf, cap))
                self._segment(pre, self._kf_pre(pre[1]), "keyframe")
            kf_key = ("kf", True, solve) if is_kf else ("kf", False)
            self._segment(kf_key, self._opt(is_kf, solve), "keyframe")
            self.last_variants = (front, pre, kf_key)
            self.mirror = (fid + 1,
                           min(kf + 1, b.window_size) if is_kf else kf,
                           0 if is_kf else n_buf)
            return self._emit()


def make_compiled_vio_estimator_step(cfg: VIOEstimatorConfig,
                                     draws=gumbel_draws, device="cuda",
                                     probe=None, window_solvers=None):
    """The per-frame VIO step (state, rig, img0, img1, gyro, accel, dts,
    imu_mask) -> (state, FrameOutput) as CUDA graphs of its segments
    (CompiledVIOStep): the counterpart of the JAX package's jitted
    make_vio_estimator_step, with the eager step's results. Pins full fp32
    and validates the config. `draws` and `window_solvers` as in
    make_vio_estimator_step (`draws` is called with the CPU as its device;
    the solvers' `counters` are carried over replays: the sharded solvers
    of parallel.dist_estimator run inside the graphs). `device`: "cuda"
    (the default; raises without a card) or "cpu", where the same segments
    run eagerly. `probe` is refused (ValueError): its counts are Python
    dict updates, which a replay would not run; use
    make_vio_estimator_step for it."""
    if probe is not None:
        raise ValueError("probe counts cannot be replayed from a CUDA graph; "
                         "use make_vio_estimator_step(cfg, probe=...)")
    eager = make_vio_estimator_step(cfg, draws, window_solvers=window_solvers)
    return CompiledVIOStep(cfg, draws, device, eager.segments,
                           getattr(window_solvers, "counters", ()))
