"""Run the estimator over a generated synthetic sequence and score it.

Port of rsvio_tpu/utils/evaluation.py, the evidence harness behind the
accuracy matrix: drives the VO or VIO per-frame step over a
data.synthetic sequence and reports SE3-aligned ATE RMSE plus
displacement drift, on the adversarial scene classes (6-DoF motion, depth
structure, photometric drift, occlusion).

What differs from the JAX module:
  * ``run_synthetic_sequence`` takes a ``device`` (default "cuda") and a
    ``dtype`` (default float32; float64 runs the rig, state, frames and IMU
    in double, as a ``precision: f64`` config does), and passes ``draws``
    and ``probe`` to the step (see models.estimator.make_estimator_step).
    Frames may be device tensors (data.synthetic renders there) or numpy
    arrays, which go up once each.
  * It drives the compiled step (CUDA graphs of the step's segments,
    models.estimator.make_compiled_estimator_step and its VIO
    counterpart), as JAX's harness drives its jitted step; on the CPU the
    same segments run eagerly. With a ``probe`` it drives the eager step,
    since a graph's replay cannot update a Python dict.
  * A frame's outputs come back in one device-to-host copy (JAX reads four
    scalars a frame, and each would be a sync here). ``RunResult`` keeps
    those reads per frame in ``stats``, beside JAX's fields.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data import synthetic as syn
from .trajectory import ate_rmse

# Per-frame outputs read each frame, in the order of the one copy: the
# position's three coordinates first, then these scalars.
FRAME_STATS = ("n_tracked", "ba_success", "is_keyframe", "pnp_success",
               "n_ransac_inliers", "n_pnp_candidates", "health",
               "n_dyn_killed")


@dataclasses.dataclass
class RunResult:
    positions: np.ndarray       # (n, 3) estimated world positions
    gt_positions: np.ndarray    # (n, 3)
    ate_rmse: float             # SE3-aligned, post-fill segment
    drift_pct: float            # |est - gt| displacement error, % of path
    n_tracked_mean: float
    ba_success_rate: float
    fps: float                  # wall-clock estimator throughput
    skip: int                   # frames excluded from ATE (window fill)
    stats: dict = dataclasses.field(default_factory=dict)  # FRAME_STATS


def static_init_imu(traj: syn.Trajectory, seconds: float = 0.5,
                    rate: float = 200.0,
                    rng: Optional[np.random.Generator] = None,
                    gyro_bias=None, accel_bias=None,
                    gyro_noise: float = 0.0, accel_noise: float = 0.0):
    """IMU samples of a body holding still at the trajectory's START pose —
    the standard hold-still-before-run initialization protocol. Feeds
    estimator_vio.initialize_vio_state."""
    hover = syn.Trajectory(pos_fn=lambda t: traj.pos_fn(0.0),
                           ang_fn=lambda t: traj.ang_fn(0.0), R0=traj.R0)
    _, gyro, accel, _ = hover.sample_imu(
        -seconds, 0.0, rate=rate, gyro_bias=gyro_bias,
        accel_bias=accel_bias, noise_rng=rng,
        gyro_noise=gyro_noise, accel_noise=accel_noise)
    return gyro, accel


def frame_imu_buffers(seq: dict, imu_buf: int):
    """Per frame k, the host IMU buffer (gyro (B,3), accel (B,3), dts (B,),
    mask (B,)) of the samples in (ts[k-1], ts[k]] (frame 0: one frame
    interval back), at most imu_buf of them."""
    ts, imu_ts = seq["ts"], seq["imu_ts"]
    bufs = []
    for k in range(len(ts)):
        lo = ts[k - 1] if k > 0 else ts[0] - (ts[1] - ts[0])
        sel = np.nonzero((imu_ts > lo) & (imu_ts <= ts[k]))[0][:imu_buf]
        gy = np.zeros((imu_buf, 3), np.float32)
        ac = np.zeros((imu_buf, 3), np.float32)
        dt = np.zeros(imu_buf, np.float32)
        mk = np.zeros(imu_buf, bool)
        gy[:len(sel)] = seq["gyro"][sel]
        ac[:len(sel)] = seq["accel"][sel]
        dt[:len(sel)] = seq["imu_dts"][sel]
        mk[:len(sel)] = True
        bufs.append((gy, ac, dt, mk))
    return bufs


def _env(name, default):
    return os.environ.get(name, str(default))


def score(positions, gt, is_kf, tracked, ba_ok, window: int):
    """(ate_rmse, drift_pct, n_tracked_mean, ba_success_rate, skip) of a
    run: the post-fill segment (the first `window` keyframes bootstrap the
    map), SE3-aligned ATE there, and the displacement error over the
    segment as a percentage of its ground-truth path length."""
    n = len(positions)
    fill = int(np.nonzero(np.cumsum(is_kf) >= window)[0][0]) + 1 \
        if is_kf.sum() >= window else n // 3
    skip = min(fill, n - 5)
    rmse, _ = ate_rmse(positions[skip:], gt[skip:])
    d_est = np.linalg.norm(positions[-1] - positions[skip])
    d_gt = np.linalg.norm(gt[-1] - gt[skip])
    path = np.sum(np.linalg.norm(np.diff(gt[skip:], axis=0), axis=1))
    drift = 100.0 * abs(d_est - d_gt) / max(path, 1e-9)
    kf_frames = is_kf[skip:]
    ba_rate = float(ba_ok[skip:][kf_frames].mean()) if kf_frames.any() \
        else 0.0
    return rmse, drift, float(tracked[skip:].mean()), ba_rate, skip


def run_synthetic_sequence(seq: dict, scene: syn.SceneConfig, *,
                           use_vio: bool = False,
                           use_marginalization: bool = False,
                           capacity: int = 256, window: int = 10,
                           levels: int = 4, max_iterations: int = 20,
                           translation_threshold: float = 0.04,
                           rotation_threshold: float = 0.04,
                           cell_size: int = 50, detect_margin: int = 19,
                           imu_buf: int = 64,
                           init_gyro=None, init_accel=None,
                           motion_prior: float = 0.0,
                           ransac: int = 0,
                           adaptive: bool = False,
                           dynamic_flow: float = 0.0,
                           pnp_cv_predict: bool = False,
                           bias_gyro_weight: float = None,
                           bias_accel_weight: float = None,
                           bias_gyro_weight_desert: float = 0.0,
                           bias_accel_weight_desert: float = 0.0,
                           use_obs_weights: bool = True,
                           coarse_level_policy: str = None,
                           backend: str = "auto", device="cuda",
                           dtype=torch.float32, draws=None,
                           probe=None) -> RunResult:
    """Drive the (V)IO estimator over a generate_sequence() output on
    `device`.

    For VIO, pass init_gyro/init_accel (e.g. static_init_imu) to engage the
    gravity-aligned bootstrap; otherwise the state starts at identity.
    `draws` (the RANSAC gate's Gumbel draws; default the step's own) goes
    to the step. Without a `probe` the step is the compiled one (its
    results are the eager step's); with one, a dict the step adds its
    option counts to, the eager step runs."""
    from ..models import ba as ba_mod
    from ..models import estimator as est
    from ..models import pnp as pnp_mod
    from ..models.frontend import FrontendConfig
    from ..ops import cameras
    from ..ops.klt import KLTConfig

    dev = torch.device(device)
    # Per-observation chi^2 outlier gate at gross-outlier scale (~6 px in
    # normalized units) — the defense against moving occluders.
    chi2 = float(_env("RSVIO_CHI2_PX", 6.0)) / float(scene.fx)
    base = est.EstimatorConfig(
        frontend=FrontendConfig(
            capacity=capacity, cell_size=cell_size,
            detect_margin=detect_margin,
            # Starvation-adaptive detection floor: keeps weak-texture scenes
            # (e.g. easy_plane) from idling at a handful of tracks.
            relax_floor_below=capacity // 2,
            relaxed_min_score=float(_env("RSVIO_RELAX_SCORE", 1.0)),
            klt=KLTConfig(levels=levels, max_iterations=max_iterations,
                          backend=backend,
                          **({} if coarse_level_policy is None else
                             dict(coarse_level_policy=coarse_level_policy)))),
        window_size=window,
        translation_threshold=translation_threshold,
        rotation_threshold=rotation_threshold,
        image_shape=(scene.H, scene.W),
        use_marginalization=use_marginalization,
        pnp_cv_predict=pnp_cv_predict,
        use_obs_weights=(use_obs_weights
                         and _env("RSVIO_OBS_WEIGHTS", 1) != "0"),
        dynamic_flow_thresh=float(_env("RSVIO_DYNFLOW", dynamic_flow)),
        dynamic_flow_decay=float(_env("RSVIO_DYNFLOW_DECAY", 0.7)),
        dynamic_flow_min_n=int(_env("RSVIO_DYNFLOW_MINN", 2)),
        # Median centring: on for VO (unanchored pose drift is common
        # mode), off for VIO (IMU-anchored pose).
        dynamic_flow_center=(_env("RSVIO_DYNFLOW_CENTER",
                                  "0" if use_vio else "1") == "1"),
        pnp_prior_adaptive=adaptive,
        vision_weight_adaptive=adaptive,
        health_floor=float(_env("RSVIO_HEALTH_FLOOR", 0.1)),
        health_f_lo=float(_env("RSVIO_HEALTH_LO", 0.5)),
        health_f_hi=float(_env("RSVIO_HEALTH_HI", 0.9)),
        health_recover=float(_env("RSVIO_HEALTH_RECOVER", 1.0)),
        pnp=pnp_mod.PnPConfig(
            chi2_gate=chi2,
            motion_prior_weight=float(_env("RSVIO_PNP_PRIOR", motion_prior)),
            ransac_hypotheses=int(_env("RSVIO_RANSAC", ransac)),
            ransac_threshold=float(_env("RSVIO_RANSAC_PX", 4.0))
            / float(scene.fx),
            # Age-weighted voting horizon (a long occluder transit
            # out-ages the default cap).
            ransac_age_cap=int(_env("RSVIO_RANSAC_AGECAP", 10))),
        ba=ba_mod.BAConfig(chi2_gate=chi2,
                           min_lm_span=int(_env("RSVIO_LM_SPAN", 1))),
    )
    params = cameras.pack_params(
        cameras.PINHOLE_RADTAN, [scene.fx, scene.fy, scene.cx, scene.cy],
        [0, 0, 0, 0], device=dev)
    T_B_Cr = torch.eye(4, dtype=torch.float32, device=dev)
    T_B_Cr[0, 3] = scene.baseline
    rig = est.make_rig(params, params,
                       torch.eye(4, dtype=torch.float32, device=dev), T_B_Cr)
    rig = type(rig)(*(x.to(dtype) for x in rig))
    step_kw = ({} if draws is None else dict(draws=draws))
    step_kw.update(dict(device=dev) if probe is None else dict(probe=probe))

    frames = seq["frames"]
    n = len(frames)
    if use_vio:
        from ..models import estimator_vio as ev
        from ..models import vio_ba
        # Bias random-walk link stiffness (the desert-drag defense): the
        # profile's weights, RSVIO_BIAS_* overrides.
        defaults = vio_ba.VIOBAConfig()
        gw = (bias_gyro_weight if bias_gyro_weight is not None
              else defaults.bias_gyro_weight)
        aw = (bias_accel_weight if bias_accel_weight is not None
              else defaults.bias_accel_weight)
        cfg = ev.VIOEstimatorConfig(
            base=base, imu_buf=imu_buf,
            vio=vio_ba.VIOBAConfig(
                chi2_gate=chi2,
                bias_gyro_weight=float(_env("RSVIO_BIAS_GW", gw)),
                bias_accel_weight=float(_env("RSVIO_BIAS_AW", aw)),
                bias_gyro_weight_desert=float(_env(
                    "RSVIO_BIAS_GW_DESERT", bias_gyro_weight_desert)),
                bias_accel_weight_desert=float(_env(
                    "RSVIO_BIAS_AW_DESERT", bias_accel_weight_desert)),
                min_lm_span=int(_env("RSVIO_LM_SPAN", 1))))
        step = (ev.make_compiled_vio_estimator_step if probe is None
                else ev.make_vio_estimator_step)(cfg, **step_kw)
        if init_gyro is not None:
            state = ev.initialize_vio_state(cfg, init_gyro, init_accel,
                                            dtype=dtype, device=dev)
        else:
            state = ev.init_vio_state(cfg, dtype=dtype, device=dev)
        imu = frame_imu_buffers(seq, imu_buf)
    else:
        step = (est.make_compiled_estimator_step if probe is None
                else est.make_estimator_step)(base, **step_kw)
        state = est.init_state(base, dtype=dtype, device=dev)

    def upload(img):
        img = torch.as_tensor(img, dtype=dtype)
        if img.device.type == "cpu" and dev.type == "cuda":
            # A pageable copy would block the host.
            return img.pin_memory().to(dev, non_blocking=True)
        return img.to(dev)

    reads = np.zeros((n, 3 + len(FRAME_STATS)))
    t0 = time.time()
    for k in range(n):
        left, right = frames[k]
        args = (state, rig, upload(left), upload(right))
        if use_vio:
            args = args + imu[k]
        state, out = step(*args)
        # One device-to-host copy a frame: position and the scalars (read
        # before the next-but-one call, which overwrites the compiled
        # step's outputs).
        reads[k] = torch.cat([
            out.T_W_B[:3, 3].to(torch.float64),
            torch.stack([getattr(out, f).to(torch.float64)
                         for f in FRAME_STATS])]).cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    positions = reads[:, :3]
    stats = {f: reads[:, 3 + i] for i, f in enumerate(FRAME_STATS)}
    for f in ("ba_success", "is_keyframe", "pnp_success"):
        stats[f] = stats[f].astype(bool)
    gt = seq["gt_T_W_B"][:, :3, 3]
    rmse, drift, tracked, ba_rate, skip = score(
        positions, gt, stats["is_keyframe"], stats["n_tracked"],
        stats["ba_success"], window)
    return RunResult(positions=positions, gt_positions=gt, ate_rmse=rmse,
                     drift_pct=drift, n_tracked_mean=tracked,
                     ba_success_rate=ba_rate, fps=n / wall, skip=skip,
                     stats=stats)
