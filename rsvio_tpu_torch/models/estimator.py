"""Estimator: the per-frame stereo VO step — frontend tracking, PnP motion
tracking, keyframe policy, sliding-window roll, triangulation and BA.

Port of rsvio_tpu/models/estimator.py. The step is built from the same named
stages (frames, track, motion, opt) and keeps the JAX layouts: poses (4,4),
window observations (W,2,N,2), masks (W,2,N), landmarks slot-aligned with
the feature table. Besides the default configuration it runs the options
the shipped VO configs switch on: score-weighted observations
(``use_obs_weights``, ``obs_weight_age_ramp``), the frontend's starvation
floor, EUCM cameras, and the RANSAC consensus gate with its outlier kill
and the adaptive track health (``pnp_prior_adaptive``,
``vision_weight_adaptive``, ``health_recover``), and the remaining window
options: marginalization of evicted keyframes into a pose prior
(``use_marginalization``), post-BA landmark culling
(``cull_reproj_threshold``), N-view refinement of fresh births
(``refine_births``), the guarded constant-velocity PnP seed
(``pnp_cv_predict``), the stereo scene-flow dynamic-object gate
(``dynamic_flow_thresh``) and tracking only once the window is full
(``track_before_full=False``).

Control flow. The JAX step is one jitted function whose data-dependent
branches are ``lax.cond``s: ``pnp_ready`` in run_motion, ``is_kf`` and
``full_now`` in stage_opt. Here the step is cut at them into two segments
(``Segments``): M (frames, track, motion) for a given pnp_ready, and K (the
keyframe stage) for a given is_kf and full_now; inside them every other
data-dependent choice (the RANSAC gate's pick, the marginalized solve's
gauge fix and prior update, the CV seed and its bound, culling,
refinement, the flow gate) is a device select. Two steps run the segments:

- ``make_estimator_step`` runs them eagerly and reads each branch from the
  device, as rsvio_tpu/parallel/dist_estimator.py does in JAX: one read a
  frame for pnp_ready (with the RANSAC gate, together with the frame id
  that seeds its draws), one for is_kf, one more on a keyframe for
  full_now.
- ``make_compiled_estimator_step``, the counterpart of ``jax.jit(step)``,
  replays CUDA graphs of the five segment variants. It mirrors kf_count
  and frame_id on the host, from which pnp_ready, full_now and the draws'
  seed follow, and reads only is_kf: one blocking read a frame
  (``CompiledStep``; ``GraphStep`` holds what it shares with the compiled
  VIO step of models/estimator_vio.py).
"""

from __future__ import annotations

import itertools
import time
from typing import NamedTuple

import torch

from .. import profiling
from ..ops import cameras, lie, projection, pyramid
from ..ops.cuda import ba_kernel, klt_kernel
from ..ops.projection import triangulate_stereo
from ..utils import graphs as graph_mod
from ..utils.precision import pin_fp32
from . import ba as ba_mod
from . import frontend as frontend_mod
from . import pnp as pnp_mod
from .frontend import FeatureTable, FrontendConfig, frontend_step, init_table
from .marginalization import MargPrior, empty_prior


class EstimatorConfig(NamedTuple):
    """Same fields and defaults as the JAX EstimatorConfig (see
    rsvio_tpu/models/estimator.py for what each one means)."""
    frontend: FrontendConfig = FrontendConfig()
    window_size: int = 10
    translation_threshold: float = 0.05
    rotation_threshold: float = 0.05
    cam_kind_l: str = cameras.PINHOLE_RADTAN
    cam_kind_r: str = cameras.PINHOLE_RADTAN
    pnp: pnp_mod.PnPConfig = pnp_mod.PnPConfig()
    ba: ba_mod.BAConfig = ba_mod.BAConfig()
    image_shape: tuple = (480, 752)
    use_marginalization: bool = False
    track_before_full: bool = True
    cull_reproj_threshold: float = 0.0
    refine_births: bool = False
    pnp_cv_predict: bool = False
    use_obs_weights: bool = False
    pnp_ransac_kill: bool = True
    dynamic_flow_thresh: float = 0.0
    dynamic_flow_decay: float = 0.7
    dynamic_flow_min_n: int = 2
    dynamic_flow_center: bool = True
    pnp_prior_adaptive: bool = False
    vision_weight_adaptive: bool = False
    health_f_lo: float = 0.5
    health_f_hi: float = 0.9
    health_floor: float = 0.1
    health_recover: float = 1.0
    obs_weight_age_ramp: float = 0.0


def validate_adaptive_knobs(cfg: EstimatorConfig) -> None:
    """The adaptive defenses need the consensus signal and the weight
    channel; raise ValueError, as the JAX package does, when a knob would
    be inert."""
    if ((cfg.pnp_prior_adaptive or cfg.vision_weight_adaptive)
            and cfg.pnp.ransac_hypotheses <= 0):
        raise ValueError(
            "pnp_prior_adaptive / vision_weight_adaptive require the RANSAC "
            "consensus gate (pnp.ransac_hypotheses > 0) as the health signal")
    if cfg.pnp_prior_adaptive and cfg.pnp.motion_prior_weight <= 0.0:
        raise ValueError(
            "pnp_prior_adaptive scales pnp.motion_prior_weight — set a "
            "positive base weight")
    if cfg.vision_weight_adaptive and not cfg.use_obs_weights:
        raise ValueError(
            "vision_weight_adaptive modulates the observation weights — "
            "enable use_obs_weights so the solvers consume them")


def check_config(cfg: EstimatorConfig) -> None:
    """Raise ValueError for incoherent or unknown values."""
    validate_adaptive_knobs(cfg)
    for kind in (cfg.cam_kind_l, cfg.cam_kind_r):
        if kind.lower() not in (cameras.PINHOLE_RADTAN, cameras.EUCM):
            raise ValueError(f"unknown camera model {kind!r}")
    frontend_mod.check_config(cfg.frontend)


class CameraRig(NamedTuple):
    params: torch.Tensor   # (2, 10) packed intrinsics
    T_C_B: torch.Tensor    # (2, 4, 4) camera-from-body
    T_B_C: torch.Tensor    # (2, 4, 4) body-from-camera


def make_rig(params_l, params_r, T_B_Cl, T_B_Cr) -> CameraRig:
    # Each camera inverted on its own, as in JAX: a (4,4) product sums in
    # the same order as JAX's, a batched one may not (1 ulp).
    return CameraRig(params=torch.stack([params_l, params_r]),
                     T_C_B=torch.stack([lie.se3_inverse(T_B_Cl),
                                        lie.se3_inverse(T_B_Cr)]),
                     T_B_C=torch.stack([T_B_Cl, T_B_Cr]))


class EstimatorState(NamedTuple):
    """Same fields as the JAX EstimatorState. Of the optional fields at the
    end, the scene-flow gate's memories (tri_prev, tri_prev_fid, flow_acc,
    flow_n) are allocated when dynamic_flow_thresh > 0, and lm_birth (the
    frozen birth-time map the RANSAC gate verifies against) and health_ema
    (the smoothed track health) when the gate is on."""
    table: FeatureTable
    pyr0: tuple              # previous-frame pyramids (tuples of levels)
    pyr1: tuple
    kf_T_W_B: torch.Tensor   # (W,4,4)
    kf_count: torch.Tensor   # () int32
    obs: torch.Tensor        # (W,2,N,2) normalized observations
    obs_mask: torch.Tensor   # (W,2,N)
    obs_fid: torch.Tensor    # (W,N) feature id tags
    obs_w: torch.Tensor      # (W,N)
    lm: torch.Tensor         # (N,3)
    lm_fid: torch.Tensor     # (N,)
    marg_prior: MargPrior
    T_W_B: torch.Tensor      # (4,4) current pose
    last_kf_T_W_B: torch.Tensor  # (4,4)
    frame_id: torch.Tensor   # () int32
    T_W_B_prev: torch.Tensor  # (4,4)
    tri_prev: torch.Tensor = None
    tri_prev_fid: torch.Tensor = None
    flow_acc: torch.Tensor = None
    flow_n: torch.Tensor = None
    lm_birth: torch.Tensor = None
    health_ema: torch.Tensor = None


def init_state(cfg: EstimatorConfig, dtype=torch.float32,
               device="cuda") -> EstimatorState:
    N = cfg.frontend.capacity
    W = cfg.window_size
    shapes = pyramid.pyramid_shapes(tuple(cfg.image_shape),
                                    cfg.frontend.klt.levels)
    pyr = tuple(torch.zeros(s, dtype=dtype, device=device) for s in shapes)
    eye = torch.eye(4, dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return EstimatorState(
        table=init_table(N, dtype, device),
        pyr0=pyr, pyr1=tuple(p.clone() for p in pyr),
        kf_T_W_B=eye.expand(W, 4, 4).clone(),
        kf_count=torch.tensor(0, **i32),
        obs=torch.zeros((W, 2, N, 2), dtype=dtype, device=device),
        obs_mask=torch.zeros((W, 2, N), dtype=torch.bool, device=device),
        obs_fid=torch.full((W, N), -1, **i32),
        obs_w=torch.ones((W, N), dtype=dtype, device=device),
        lm=torch.zeros((N, 3), dtype=dtype, device=device),
        lm_fid=torch.full((N,), -1, **i32),
        marg_prior=empty_prior(W, 6, dtype, device),
        T_W_B=eye.clone(), last_kf_T_W_B=eye.clone(),
        frame_id=torch.tensor(0, **i32),
        T_W_B_prev=eye.clone(),
        **(dict(tri_prev=torch.zeros((N, 3), dtype=dtype, device=device),
                tri_prev_fid=torch.full((N,), -1, **i32),
                flow_acc=torch.zeros((N, 2), dtype=dtype, device=device),
                flow_n=torch.zeros((N,), **i32))
           if cfg.dynamic_flow_thresh > 0 else {}),
        **(dict(lm_birth=torch.zeros((N, 3), dtype=dtype, device=device),
                health_ema=torch.tensor(1.0, dtype=dtype, device=device))
           if cfg.pnp.ransac_hypotheses > 0 else {}),
    )


class FrameOutput(NamedTuple):
    T_W_B: torch.Tensor
    is_keyframe: torch.Tensor
    pnp_success: torch.Tensor
    ba_success: torch.Tensor
    ba_iterations: torch.Tensor
    ba_final_cost: torch.Tensor
    n_tracked: torch.Tensor   # tracks surviving this frame's temporal pass
    n_landmarks: torch.Tensor
    n_alive: torch.Tensor     # table occupancy after births
    pose_ok: torch.Tensor = True
    n_dyn_killed: torch.Tensor = 0
    n_ransac_inliers: torch.Tensor = 0
    n_pnp_candidates: torch.Tensor = 0
    health: torch.Tensor = 1.0


RANSAC_SEED = 0x5A11AC


def gumbel_draws(frame_id: int, shape, dtype, device):
    """The RANSAC gate's Gumbel(0, 1) draws for one frame: -log of
    exponential draws from a CPU generator seeded by (RANSAC_SEED,
    frame_id). Deterministic on replay, the same numbers for a step on the
    CPU and on the card, and copied to `device` without a stream sync.
    (The JAX package draws from a threefry key folded with the frame id,
    which torch cannot reproduce; tests pass JAX's draws instead.)"""
    gen = torch.Generator().manual_seed((RANSAC_SEED << 32) | frame_id)
    e = torch.empty(shape, dtype=torch.float64).exponential_(generator=gen)
    return (-torch.log(e)).to(dtype).to(device, non_blocking=True)


def effective_weights(cfg: EstimatorConfig, table: FeatureTable):
    """Per-slot observation weights: the birth-score weight, optionally
    forgiven with age (EstimatorConfig.obs_weight_age_ramp)."""
    w = table.w
    if cfg.obs_weight_age_ramp > 0.0:
        w = 1.0 - (1.0 - w) * torch.exp(
            -cfg.obs_weight_age_ramp * table.age.to(w.dtype))
    return w


def excise_outliers(table: FeatureTable, obs_cur_mask, lm_fid, kill):
    """RANSAC outlier excision before the window insert: a killed slot
    dies, its current observation never enters the window and its landmark
    is invalidated."""
    return (table._replace(alive=table.alive & ~kill),
            obs_cur_mask & ~kill[None, :],
            torch.where(kill, torch.full_like(lm_fid, -1), lm_fid))


def _undistort_table(cfg: EstimatorConfig, rig: CameraRig,
                     table: FeatureTable):
    """Normalized coords of every slot in both cams: (2,N,2), (2,N)."""
    xy0 = cameras.unproject(cfg.cam_kind_l, rig.params[0], table.pos0)
    xy1 = cameras.unproject(cfg.cam_kind_r, rig.params[1], table.pos1)
    return (torch.stack([xy0, xy1]),
            torch.stack([table.alive, table.alive]))


def _triangulate_new(rig: CameraRig, T_W_B, obs_cur, table: FeatureTable,
                     lm, lm_fid):
    """Triangulate landmarks for alive slots without a valid one; invalidate
    landmarks of recycled or dead slots. Returns (lm, lm_fid, born, p,
    tri_ok): born marks the slots triangulated by this call, p / tri_ok are
    every slot's instantaneous stereo triangulation (read by the birth
    refinement and the scene-flow gate)."""
    T_W_C = T_W_B @ rig.T_B_C                               # (2,4,4)
    p, tri_ok = triangulate_stereo(T_W_C[0], T_W_C[1], obs_cur[0],
                                   obs_cur[1])
    has_lm = (lm_fid == table.fid) & (lm_fid >= 0)
    want = table.alive & (~has_lm) & tri_ok
    lm = torch.where(want[:, None], p, lm)
    lm_fid = torch.where(want, table.fid, lm_fid)
    stale = (lm_fid != table.fid) | (~table.alive)
    lm_fid = torch.where(stale & ~want, torch.full_like(lm_fid, -1), lm_fid)
    return lm, lm_fid, want, p, tri_ok


def reprojection_outliers(T_C_B, kf_T_W_B, lm, obs, eff_mask, lm_valid,
                          thr_sq):
    """Valid landmarks whose worst squared reprojection error over the
    window's masked observations exceeds thr_sq, or that lie behind a
    camera there. Returns (N,) bool."""
    T_B_W = lie.se3_inverse(kf_T_W_B)[:, None, None]      # (W,1,1,4,4)
    T_cb = T_C_B[None, :, None]                            # (1,2,1,4,4)
    p_B = (T_B_W[..., :3, :3] @ lm[None, None, :, :, None])[..., 0] \
        + T_B_W[..., :3, 3]
    p_C = (T_cb[..., :3, :3] @ p_B[..., None])[..., 0] + T_cb[..., :3, 3]
    z = torch.clamp(p_C[..., 2], min=1e-6)
    proj = p_C[..., :2] / z[..., None]
    err = ((proj - obs) ** 2).sum(-1)                      # (W,2,N)
    err = torch.where(p_C[..., 2] > 1e-6, err, torch.full_like(err,
                                                                torch.inf))
    err = torch.where(eff_mask, err, torch.zeros_like(err))
    return lm_valid & (err.amax(dim=(0, 1)) > thr_sq)


def nanmedian_columns(x):
    """(M, K) -> (K,): each column's median over its non-NaN entries, the
    two middle values averaged for an even count as ``jnp.nanmedian`` does
    (``torch.nanmedian`` takes the lower one), NaN for a column without
    one. The interpolation weights are JAX's, so the values agree to the
    last bit."""
    srt, _ = torch.sort(x, dim=0)                  # NaNs sort last
    n = (~torch.isnan(x)).sum(dim=0)
    q = 0.5 * (n - 1).to(x.dtype)
    lo_q, hi_q = torch.floor(q), torch.ceil(q)
    w_hi = q - lo_q
    top = torch.clamp(n - 1, min=0)
    lo = torch.minimum(torch.clamp(lo_q, min=0).long(), top)
    hi = torch.minimum(torch.clamp(hi_q, min=0).long(), top)
    return (srt.gather(0, lo[None])[0] * (1.0 - w_hi)
            + srt.gather(0, hi[None])[0] * w_hi)


def scene_flow_gate(cfg: EstimatorConfig, rig: CameraRig, T_cur, obs_cur,
                    obs_cur_mask, table: FeatureTable, tri_all, tri_ok,
                    tri_prev, tri_prev_fid, flow_acc, flow_n):
    """Stereo scene-flow dynamic-object gate (EstimatorConfig.
    dynamic_flow_thresh): the previous keyframe's instantaneous
    triangulation of each track is reprojected into the current left
    camera; the residual flow against the current observation, optionally
    median-centred, is accumulated with decay, and a track whose
    accumulated norm exceeds the threshold after dynamic_flow_min_n
    measurements is killed. Returns (kill (N,), tri_mem, n_dyn) with
    tri_mem the updated (tri_prev, tri_prev_fid, flow_acc, flow_n)."""
    tri_valid = tri_ok & table.alive
    T_C_W = rig.T_C_B[0] @ lie.se3_inverse(T_cur)
    pC = (tri_prev @ T_C_W[:3, :3].T) + T_C_W[:3, 3]
    in_front = pC[:, 2] > 1e-6
    proj = pC[:, :2] / torch.clamp(pC[:, 2:3], min=1e-6)
    have_flow = (tri_valid & in_front & obs_cur_mask[0]
                 & (tri_prev_fid == table.fid) & (tri_prev_fid >= 0))
    flow = obs_cur[0] - proj                              # (N,2)
    if cfg.dynamic_flow_center:
        med = nanmedian_columns(torch.where(
            have_flow[:, None], flow, torch.full_like(flow, torch.nan)))
        flow = flow - torch.where(torch.isfinite(med), med,
                                  torch.zeros_like(med))
    acc = torch.where(have_flow[:, None],
                      cfg.dynamic_flow_decay * flow_acc + flow,
                      torch.zeros_like(flow))
    n_fl = torch.where(have_flow, flow_n + 1, torch.zeros_like(flow_n))
    kill = (have_flow & (n_fl >= cfg.dynamic_flow_min_n)
            & (torch.linalg.vector_norm(acc, dim=1)
               > cfg.dynamic_flow_thresh))
    acc = torch.where(kill[:, None], torch.zeros_like(acc), acc)
    n_fl = torch.where(kill, torch.zeros_like(n_fl), n_fl)
    fid_mem = torch.where(tri_valid & ~kill, table.fid,
                          torch.full_like(table.fid, -1))
    return (kill, (tri_all, fid_mem, acc, n_fl),
            kill.to(torch.int32).sum(dtype=torch.int32))


def cv_seed(state: EstimatorState):
    """The guarded constant-velocity PnP seed (pnp_cv_predict): the last
    frame-to-frame motion extrapolated once, or the last keyframe's pose
    where that motion is non-finite or implausible (>= 0.5 m or >= 0.5
    rad). Returns (T_pred, cv_ok)."""
    delta = lie.se3_inverse(state.T_W_B_prev) @ state.T_W_B
    cv_ok = (torch.isfinite(delta).all()
             & (torch.linalg.vector_norm(delta[:3, 3]) < 0.5)
             & (lie.rotation_angle(delta[:3, :3]) < 0.5))
    return torch.where(cv_ok, state.T_W_B @ delta, state.last_kf_T_W_B), cv_ok


class MotionOut(NamedTuple):
    T_cur: torch.Tensor        # (4,4) pose after PnP + health gate
    pnp_success: torch.Tensor  # () bool (includes pose_ok)
    is_kf: torch.Tensor        # () bool
    pose_ok: torch.Tensor      # () bool numerical-health flag
    kill: torch.Tensor         # (N,) RANSAC outlier excision set
    ransac_ok: torch.Tensor    # () bool consensus gate engaged and won
    n_inliers: torch.Tensor    # () int32 winning consensus size (0 off)
    n_pnp: torch.Tensor        # () int32 PnP candidate observations
    health: torch.Tensor = 1.0  # () track health in [0, 1] (1 gate off)


def pnp_ready(cfg: EstimatorConfig, kf_count):
    """Whether PnP engages on a frame that starts with kf_count keyframes
    (an int or a 0-d tensor): once any landmark exists, or with
    track_before_full=False only once the window is full."""
    return kf_count >= (1 if cfg.track_before_full else cfg.window_size)


def full_now(cfg: EstimatorConfig, kf_count):
    """Whether a keyframe inserted into a window of kf_count keyframes (an
    int or a 0-d tensor) runs the window solve: once two keyframes exist,
    or with track_before_full=False once the window is full (the new count
    min(kf_count + 1, W) reaches the threshold, which is at most W)."""
    return kf_count + 1 >= (2 if cfg.track_before_full else cfg.window_size)


def read_motion_branch(cfg: EstimatorConfig, kf_count, frame_id, draws,
                       n_slots: int, dtype, device):
    """The host's side of JAX's lax.cond on pnp_ready: one read of the
    state's counts, which with the RANSAC gate on also brings the frame id
    that seeds its draws. Returns (ready, the gate's Gumbel draws
    (K, 2 n_slots) or None)."""
    if cfg.pnp.ransac_hypotheses <= 0:
        return bool(pnp_ready(cfg, kf_count)), None
    ready, fid = torch.stack([pnp_ready(cfg, kf_count).to(torch.int64),
                              frame_id.to(torch.int64)]).tolist()
    if not ready:
        return False, None
    return True, draws(fid, (cfg.pnp.ransac_hypotheses, 2 * n_slots), dtype,
                       device)


def run_motion(cfg: EstimatorConfig, rig: CameraRig, table, obs_cur,
               obs_cur_mask, lm, lm_fid, lm_birth, kf_count, last_kf_T_W_B,
               T_pred, T_gate_seed, T_prior, T_fallback, ready: bool,
               gumbel=None, obs_w_slots=None, cv_bound_check=False,
               health_prev=None) -> MotionOut:
    """PnP motion tracking + keyframe policy: the optional RANSAC pre-gate
    (verified against the frozen birth map lm_birth, hypotheses seeded at
    T_gate_seed, on the Gumbel draws `gumbel`), the track health from its
    inlier fraction, the LM PnP polish with optional score weights
    obs_w_slots and health-scaled motion prior, the keyframe-relative bound
    of the constant-velocity seed (cv_bound_check), the numerical-health
    recovery, the keyframe test and the outlier kill. `ready` is the host's
    pnp_ready (JAX's lax.cond on it): the gate and PnP run only when it is
    true (read_motion_branch reads it; the compiled step mirrors it)."""
    dev, dtype = T_pred.device, T_pred.dtype
    window_full = kf_count >= cfg.window_size

    lm_ok = (lm_fid == table.fid) & (lm_fid >= 0) & table.alive
    pnp_mask = obs_cur_mask & lm_ok[None, :]
    n_pnp = pnp_mask.to(torch.int32).sum(dtype=torch.int32)

    false = torch.zeros((), dtype=torch.bool, device=dev)
    use_ransac = cfg.pnp.ransac_hypotheses > 0
    inl_mask, ransac_ok = pnp_mask, false
    n_inl = torch.zeros((), dtype=torch.int32, device=dev)
    health = torch.ones((), dtype=dtype, device=dev)
    if ready and use_ransac:
        inl_mask, ransac_ok, n_inl = pnp_mod.ransac_pnp_gate(
            T_gate_seed, rig.T_C_B, lm_birth, obs_cur, pnp_mask, gumbel,
            cfg.pnp, age=table.age)
        # Health: the consensus inlier fraction ramped between health_f_lo
        # and health_f_hi; a gate that ran and found no consensus reads
        # health_floor.
        f_inl = n_inl.to(dtype) / torch.clamp(n_pnp.to(dtype), min=1.0)
        ramp = torch.clamp((f_inl - cfg.health_f_lo)
                           / max(cfg.health_f_hi - cfg.health_f_lo, 1e-6),
                           0.0, 1.0)
        health = torch.where(ransac_ok, ramp, torch.full(
            (), cfg.health_floor, dtype=dtype, device=dev))
    if use_ransac and cfg.health_recover < 1.0 and health_prev is not None:
        # Hysteresis: drop at once, recover at most health_recover a frame.
        health = torch.minimum(health, health_prev + cfg.health_recover)

    if ready:
        res = pnp_mod.solve_pnp(
            T_pred, rig.T_C_B, lm, obs_cur, inl_mask, cfg.pnp,
            T_W_B_prior=T_prior, obs_weight=obs_w_slots,
            prior_scale=1.0 - health if cfg.pnp_prior_adaptive else None)
        T_pnp, pnp_success = res.T_W_B, res.success
    else:
        T_pnp, pnp_success = T_fallback, false
    if cv_bound_check:
        # Motion since the last keyframe beyond ~10 keyframe thresholds is
        # the extrapolation's feedback loop, not the camera: fail PnP.
        rel = lie.se3_inverse(last_kf_T_W_B) @ T_pnp
        bound_ok = ((torch.linalg.vector_norm(rel[:3, 3])
                     <= 10.0 * cfg.translation_threshold + 0.5)
                    & (lie.rotation_angle(rel[:3, :3])
                       <= 10.0 * cfg.rotation_threshold + 0.5))
        pnp_success = pnp_success & bound_ok
    T_cur = torch.where(pnp_success, T_pnp, T_fallback)

    # Numerical-health gate: a non-finite pose recovers to the last keyframe.
    pose_ok = torch.isfinite(T_cur).all()
    T_cur = torch.where(pose_ok, T_cur, last_kf_T_W_B)

    # Keyframe policy.
    T_rel = lie.se3_inverse(last_kf_T_W_B) @ T_cur
    t_norm = torch.linalg.vector_norm(T_rel[:3, 3])
    r_norm = lie.rotation_angle(T_rel[:3, :3])
    is_kf = torch.where(window_full,
                        (t_norm > cfg.translation_threshold)
                        | (r_norm > cfg.rotation_threshold),
                        torch.ones((), dtype=torch.bool, device=dev))

    # RANSAC outlier kill: tracks whose map observation fell outside the
    # winning consensus, when the gate won and the polish succeeded.
    if use_ransac and cfg.pnp_ransac_kill:
        kill = ((pnp_mask & ~inl_mask).any(dim=0) & ransac_ok & pnp_success
                & pose_ok)
    else:
        kill = torch.zeros_like(table.alive)
    return MotionOut(T_cur=T_cur, pnp_success=pnp_success & pose_ok,
                     is_kf=is_kf, pose_ok=pose_ok, kill=kill,
                     ransac_ok=ransac_ok, n_inliers=n_inl, n_pnp=n_pnp,
                     health=health)


class KFPrep(NamedTuple):
    """Keyframe prologue outputs consumed by the window solve and the
    epilogue (the JAX KFPrep's fields)."""
    table: FeatureTable       # after the scene-flow gate's kills
    kf_T: torch.Tensor        # (W,4,4) rolled window incl. this keyframe
    kf_count: torch.Tensor    # () int32 new count
    obs_w: torch.Tensor       # (W,2,N,2)
    obs_m: torch.Tensor       # (W,2,N)
    obs_f: torch.Tensor       # (W,N)
    obs_wt: torch.Tensor      # (W,N)
    lm: torch.Tensor          # (N,3)
    lm_fid: torch.Tensor      # (N,)
    eff_mask: torch.Tensor    # (W,2,N) BA observation validity
    lm_valid: torch.Tensor    # (N,)
    tri_mem: tuple            # scene-flow gate memory (4 tensors or Nones)
    n_dyn: torch.Tensor       # () int32 tracks killed by the flow gate
    lm_birth: torch.Tensor    # (N,3) frozen birth map (None: gate off)
    full_now: torch.Tensor    # () bool run BA this keyframe
    will_evict: torch.Tensor  # () bool the next insert rolls the window


class Stages(NamedTuple):
    """The per-frame step as named stages (the reference's [Timing] split):
    frames -> frame_creation, track -> patch_tracking, motion ->
    motion_tracking, opt -> optimization."""
    frames: callable
    track: callable
    motion: callable
    opt: callable


def _count(probe, key, mask):
    """Add mask's count to probe[key] on the device (no sync)."""
    if probe is not None:
        probe[key] = probe.get(key, 0) + mask.to(torch.int64).sum()


def _build_stages(cfg: EstimatorConfig, probe=None,
                  window_solvers=None) -> Stages:
    check_config(cfg)
    solvers = ba_mod if window_solvers is None else window_solvers
    W = cfg.window_size
    levels = cfg.frontend.klt.levels

    def stage_frames(img0, img1):
        return (pyramid.build_pyramid(img0, levels),
                pyramid.build_pyramid(img1, levels))

    def stage_track(state: EstimatorState, rig: CameraRig, pyr0, pyr1):
        # The first frame has no previous pyramids; its (zero) pyramids are
        # tracked with every slot masked dead, so the kernel still runs
        # exactly twice per frame.
        table_in = state.table._replace(
            alive=state.table.alive & (state.frame_id > 0))
        table, fstats = frontend_step(table_in, state.pyr0, state.pyr1,
                                      pyr0, pyr1, cfg.frontend)
        obs_cur, obs_cur_mask = _undistort_table(cfg, rig, table)
        return table, fstats, obs_cur, obs_cur_mask

    def stage_motion(state: EstimatorState, rig: CameraRig, table, obs_cur,
                     obs_cur_mask, ready: bool, gumbel) -> MotionOut:
        # Init from the current (last-optimized) pose, or from the guarded
        # constant-velocity seed; the prior anchor is always the measured
        # previous pose.
        T_pred = state.T_W_B
        if cfg.pnp_cv_predict:
            T_pred, cv_ok = cv_seed(state)
            _count(probe, "cv_seeded", cv_ok)
            _count(probe, "cv_fallback", ~cv_ok)
        return run_motion(
            cfg, rig, table, obs_cur, obs_cur_mask, state.lm, state.lm_fid,
            state.lm_birth, state.kf_count, state.last_kf_T_W_B,
            T_pred=T_pred, T_gate_seed=state.T_W_B, T_prior=state.T_W_B,
            T_fallback=state.T_W_B, ready=ready, gumbel=gumbel,
            obs_w_slots=(effective_weights(cfg, table)
                         if cfg.use_obs_weights else None),
            cv_bound_check=cfg.pnp_cv_predict,
            health_prev=state.health_ema)

    def stage_kf_pre(state: EstimatorState, rig: CameraRig, table, obs_cur,
                     obs_cur_mask, T_cur, health) -> KFPrep:
        """Triangulate new landmarks, run the scene-flow gate, FIFO-roll the
        window, insert the frame, build the BA masks, optionally refine the
        births. Works on copies; the input state is not modified. `state`
        carries the excised lm_fid."""
        window_full = state.kf_count >= W
        lm, lm_fid, born, tri_all, tri_ok = _triangulate_new(
            rig, T_cur, obs_cur, table, state.lm, state.lm_fid)
        tri_mem = (state.tri_prev, state.tri_prev_fid, state.flow_acc,
                   state.flow_n)
        n_dyn = torch.zeros((), dtype=torch.int32, device=T_cur.device)
        if cfg.dynamic_flow_thresh > 0:
            kill_dyn, tri_mem, n_dyn = scene_flow_gate(
                cfg, rig, T_cur, obs_cur, obs_cur_mask, table, tri_all,
                tri_ok, *tri_mem)
            table = table._replace(alive=table.alive & ~kill_dyn)
            lm_fid = torch.where(kill_dyn, torch.full_like(lm_fid, -1),
                                 lm_fid)
            _count(probe, "flow_tracked", tri_mem[3] > 0)
        obs_cur_mask_eff = obs_cur_mask & table.alive[None, :]
        # Frozen verification map: capture births, never refit.
        lm_birth = (torch.where(born[:, None], tri_all, state.lm_birth)
                    if state.lm_birth is not None else None)
        ins = torch.clamp(state.kf_count, max=W - 1).to(torch.int64)
        ins = ins.reshape(1)

        def roll_insert(arr, row):
            # FIFO roll when full, then insert at min(kf_count, W-1).
            out = torch.where(window_full, torch.roll(arr, -1, dims=0), arr)
            return out.index_copy(0, ins, row[None].to(arr.dtype))

        kf_T = roll_insert(state.kf_T_W_B, T_cur)
        obs_w = roll_insert(state.obs, obs_cur)
        obs_m = roll_insert(state.obs_mask, obs_cur_mask_eff)
        obs_f = roll_insert(state.obs_fid, table.fid)
        w_ins = effective_weights(cfg, table)
        if cfg.vision_weight_adaptive:
            # Low-consensus frames bring less visual information.
            w_ins = w_ins * torch.clamp(health.to(w_ins.dtype),
                                        min=cfg.health_floor)
        obs_wt = roll_insert(state.obs_w, w_ins)
        kf_count = torch.clamp(state.kf_count + 1, max=W)
        # BA once two keyframes exist, or with track_before_full=False
        # only once the window is full.
        full_now = kf_count >= (2 if cfg.track_before_full else W)
        eff_mask = obs_m & (obs_f == table.fid[None, :])[:, None, :]
        kf_valid = torch.arange(W, device=kf_count.device) < kf_count
        eff_mask = eff_mask & kf_valid[:, None, None]
        lm_valid = (lm_fid == table.fid) & (lm_fid >= 0)
        if cfg.refine_births:
            # Polish fresh births against every window observation of their
            # feature, the rolled window's poses fixed, before BA.
            lm_ref, ok_ref = projection.refine_landmarks(
                rig.T_C_B, lie.se3_inverse(kf_T), lm, obs_w,
                eff_mask & born[None, None, :])
            refined = born & ok_ref
            lm = torch.where(refined[:, None], lm_ref, lm)
            _count(probe, "refined", refined)
        # will_evict is not full_now: a prior made before the window is at
        # capacity would be rolled against a window that does not roll.
        return KFPrep(table=table, kf_T=kf_T, kf_count=kf_count, obs_w=obs_w,
                      obs_m=obs_m, obs_f=obs_f, obs_wt=obs_wt, lm=lm,
                      lm_fid=lm_fid, eff_mask=eff_mask, lm_valid=lm_valid,
                      tri_mem=tri_mem, n_dyn=n_dyn, lm_birth=lm_birth,
                      full_now=full_now, will_evict=kf_count >= W)

    def ba_solve(prep: KFPrep, rig: CameraRig, marg_prior):
        """The window solve: (poses, landmarks, ok, iterations, cost, the
        next marginalization prior)."""
        ba_w = prep.obs_wt if cfg.use_obs_weights else None
        if cfg.use_marginalization:
            res, new_prior = solvers.solve_ba_marginalized(
                prep.kf_T, rig.T_C_B, prep.lm, prep.obs_w, prep.eff_mask,
                prep.lm_valid, marg_prior, prep.will_evict, cfg.ba,
                obs_weight=ba_w)
            _count(probe, "priors_made", prep.will_evict & res.success)
        else:
            res = solvers.solve_ba(prep.kf_T, rig.T_C_B, prep.lm,
                                   prep.obs_w, prep.eff_mask, prep.lm_valid,
                                   cfg.ba, obs_weight=ba_w)
            new_prior = marg_prior
        return (res.T_W_B, res.landmarks, res.success, res.iterations,
                res.final_cost, new_prior)

    def stage_kf_post(prep: KFPrep, rig: CameraRig, res_T, res_lm, ba_ok):
        """Accept or reject the solve, cull landmarks the accepted window
        cannot explain (cull_reproj_threshold), and take the new pose."""
        kf_T = torch.where(ba_ok, res_T, prep.kf_T)
        lm = torch.where(ba_ok, res_lm, prep.lm)
        lm_fid = prep.lm_fid
        if cfg.cull_reproj_threshold > 0.0:
            bad = reprojection_outliers(
                rig.T_C_B, kf_T, lm, prep.obs_w, prep.eff_mask,
                prep.lm_valid, cfg.cull_reproj_threshold ** 2) & ba_ok
            lm_fid = torch.where(bad, torch.full_like(lm_fid, -1), lm_fid)
            _count(probe, "cull_checked", prep.lm_valid & ba_ok)
            _count(probe, "culled", bad)
        last = (torch.clamp(prep.kf_count, max=W) - 1).to(torch.int64)
        T_new = kf_T.index_select(0, last.reshape(1))[0]
        return kf_T, lm, lm_fid, T_new

    def stage_opt(state: EstimatorState, rig: CameraRig, pyr0, pyr1, table,
                  fstats, obs_cur, obs_cur_mask, mo: MotionOut, is_kf: bool,
                  solve: bool):
        """The keyframe stage for the host's is_kf and, on a keyframe,
        full_now (`solve`): JAX's lax.conds on both."""
        dev = mo.T_cur.device
        T_cur = mo.T_cur
        if cfg.pnp.ransac_hypotheses > 0 and cfg.pnp_ransac_kill:
            table, obs_cur_mask, lm_fid0 = excise_outliers(
                table, obs_cur_mask, state.lm_fid, mo.kill)
            state = state._replace(lm_fid=lm_fid0)
        if is_kf:
            prep = stage_kf_pre(state, rig, table, obs_cur, obs_cur_mask,
                                T_cur, mo.health)
            # A skipped solve passes the prior through unchanged.
            if solve:
                res_T, res_lm, ba_ok, ba_it, ba_cost, marg_prior = ba_solve(
                    prep, rig, state.marg_prior)
            else:
                res_T, res_lm = prep.kf_T, prep.lm
                ba_ok = torch.zeros((), dtype=torch.bool, device=dev)
                ba_it = torch.zeros((), dtype=torch.int32, device=dev)
                ba_cost = torch.zeros((), dtype=T_cur.dtype, device=dev)
                marg_prior = state.marg_prior
            kf_T, lm, lm_fid, T_new = stage_kf_post(prep, rig, res_T,
                                                    res_lm, ba_ok)
            kf_count, obs_w, obs_m, obs_f, obs_wt, lm_birth = (
                prep.kf_count, prep.obs_w, prep.obs_m, prep.obs_f,
                prep.obs_wt, prep.lm_birth)
            table = prep.table
            tri_mem, n_dyn = prep.tri_mem, prep.n_dyn
            T_out, last_kf = T_new, T_new
        else:
            kf_T, kf_count = state.kf_T_W_B, state.kf_count
            obs_w, obs_m, obs_f, obs_wt = (state.obs, state.obs_mask,
                                           state.obs_fid, state.obs_w)
            lm, lm_fid, lm_birth = state.lm, state.lm_fid, state.lm_birth
            marg_prior = state.marg_prior
            tri_mem = (state.tri_prev, state.tri_prev_fid, state.flow_acc,
                       state.flow_n)
            n_dyn = torch.zeros((), dtype=torch.int32, device=dev)
            T_out, last_kf = T_cur, state.last_kf_T_W_B
            ba_ok = torch.zeros((), dtype=torch.bool, device=dev)
            ba_it = torch.zeros((), dtype=torch.int32, device=dev)
            ba_cost = torch.zeros((), dtype=T_cur.dtype, device=dev)

        new_state = EstimatorState(
            table=table, pyr0=pyr0, pyr1=pyr1, kf_T_W_B=kf_T,
            kf_count=kf_count, obs=obs_w, obs_mask=obs_m, obs_fid=obs_f,
            obs_w=obs_wt, lm=lm, lm_fid=lm_fid, marg_prior=marg_prior,
            T_W_B=T_out, last_kf_T_W_B=last_kf,
            frame_id=state.frame_id + 1, T_W_B_prev=state.T_W_B,
            tri_prev=tri_mem[0], tri_prev_fid=tri_mem[1],
            flow_acc=tri_mem[2], flow_n=tri_mem[3],
            lm_birth=lm_birth,
            health_ema=mo.health if state.health_ema is not None else None)
        out = FrameOutput(
            T_W_B=T_out, is_keyframe=mo.is_kf, pnp_success=mo.pnp_success,
            ba_success=ba_ok, ba_iterations=ba_it, ba_final_cost=ba_cost,
            n_tracked=fstats["tracked"],
            n_landmarks=((lm_fid == table.fid) & (lm_fid >= 0))
            .to(torch.int32).sum(dtype=torch.int32),
            n_alive=fstats["alive"], pose_ok=mo.pose_ok,
            n_dyn_killed=n_dyn,
            n_ransac_inliers=mo.n_inliers, n_pnp_candidates=mo.n_pnp,
            health=mo.health)
        return new_state, out

    return Stages(frames=stage_frames, track=stage_track,
                  motion=stage_motion, opt=stage_opt)


class MotionSeg(NamedTuple):
    """Segment M's results: the frame's pyramids, the tracked table and its
    counts, this frame's observations and the motion stage's outputs."""
    pyr0: tuple
    pyr1: tuple
    table: FeatureTable
    fstats: dict
    obs_cur: torch.Tensor
    obs_cur_mask: torch.Tensor
    mo: MotionOut


class Segments(NamedTuple):
    """The step cut at its three branch points (JAX's lax.conds on
    pnp_ready, is_kf and full_now), each branch a host argument:
    motion(state, rig, img0, img1, ready, gumbel) -> MotionSeg (segment M:
    frames, track, motion) and opt(state, rig, seg, is_kf, solve) ->
    (state, FrameOutput) (segment K: the keyframe stage)."""
    motion: callable
    opt: callable


def _build_segments(st: Stages) -> Segments:
    def motion(state, rig, img0, img1, ready: bool, gumbel) -> MotionSeg:
        pyr0, pyr1 = st.frames(img0, img1)
        table, fstats, obs_cur, obs_cur_mask = st.track(state, rig, pyr0,
                                                        pyr1)
        mo = st.motion(state, rig, table, obs_cur, obs_cur_mask, ready,
                       gumbel)
        return MotionSeg(pyr0, pyr1, table, fstats, obs_cur, obs_cur_mask,
                         mo)

    def opt(state, rig, seg: MotionSeg, is_kf: bool, solve: bool):
        return st.opt(state, rig, *seg, is_kf, solve)

    return Segments(motion=motion, opt=opt)


def read_opt_branch(cfg: EstimatorConfig, state: EstimatorState,
                    mo: MotionOut):
    """The host's side of JAX's lax.conds on is_kf and full_now: one read a
    frame, and one more on a keyframe. Returns (is_kf, solve)."""
    is_kf = bool(mo.is_kf)
    return is_kf, is_kf and bool(full_now(cfg, state.kf_count))


def make_estimator_step(cfg: EstimatorConfig, draws=gumbel_draws,
                        probe=None, window_solvers=None):
    """Build the per-frame step (state, rig, img0, img1) -> (state, out).
    Pins full fp32 (``utils.precision.pin_fp32``) and validates the config
    when called. `draws(frame_id, shape, dtype, device)` gives the RANSAC
    gate's Gumbel draws (tests pass the JAX package's). `probe`: an
    optional dict into which the step adds, as device counts, what the
    window options did — "cv_seeded" / "cv_fallback" (frames whose PnP
    started from the constant-velocity seed or fell back to the last
    keyframe), "refined", "cull_checked" and "culled" (landmarks refined
    at birth, held to the cull threshold after an accepted solve, and
    culled), "flow_tracked" (tracks carrying an accumulated scene flow
    after a keyframe's gate), "priors_made" (marginalized solves that
    produced the next prior). `window_solvers`: the window solve's
    functions, an object with ``solve_ba`` and ``solve_ba_marginalized``
    of models.ba's signatures (default models.ba itself;
    parallel.dist_estimator passes the landmark-sharded ones), and
    optionally ``counters``, the Python counters their calls advance
    (utils.graphs.Graphs; the compiled step carries them over replays).

    The step runs the segments eagerly and reads its branches from the
    device: two blocking reads a frame, three on a keyframe
    (make_compiled_estimator_step mirrors them on the host instead). Its
    `segments` attribute holds them: the compiled step replays these."""
    pin_fp32()
    sg = _build_segments(_build_stages(cfg, probe, window_solvers))

    def step(state: EstimatorState, rig: CameraRig, img0, img1):
        ready, gumbel = read_motion_branch(
            cfg, state.kf_count, state.frame_id, draws, state.lm.shape[0],
            state.T_W_B.dtype, state.T_W_B.device)
        seg = sg.motion(state, rig, img0, img1, ready, gumbel)
        return sg.opt(state, rig, seg, *read_opt_branch(cfg, state, seg.mo))

    step.segments = sg
    return step


STAGE_NAMES = ("frame_creation", "patch_tracking", "motion_tracking",
               "optimization")


def make_estimator_split_step(cfg: EstimatorConfig, draws=gumbel_draws,
                              probe=None, window_solvers=None):
    """The step with a synchronized per-stage split: returns
    step(state, rig, img0, img1) -> (state, out, times_ms) with times_ms a
    dict over STAGE_NAMES. Same stages, arguments and results as
    make_estimator_step; the syncs make it slower, so use it for diagnosis.
    """
    pin_fp32()
    st = _build_stages(cfg, probe, window_solvers)

    def sync(device):
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step(state: EstimatorState, rig: CameraRig, img0, img1):
        dev = img0.device
        times = {}
        sync(dev)
        t0 = time.perf_counter()
        pyr0, pyr1 = st.frames(img0, img1)
        sync(dev)
        t1 = time.perf_counter()
        tr = st.track(state, rig, pyr0, pyr1)
        sync(dev)
        t2 = time.perf_counter()
        ready, gumbel = read_motion_branch(
            cfg, state.kf_count, state.frame_id, draws, state.lm.shape[0],
            state.T_W_B.dtype, state.T_W_B.device)
        mo = st.motion(state, rig, tr[0], tr[2], tr[3], ready, gumbel)
        sync(dev)
        t3 = time.perf_counter()
        new_state, out = st.opt(state, rig, pyr0, pyr1, *tr, mo,
                                *read_opt_branch(cfg, state, mo))
        sync(dev)
        t4 = time.perf_counter()
        for name, a, b in zip(STAGE_NAMES, (t0, t1, t2, t3), (t1, t2, t3, t4)):
            times[name] = (b - a) * 1e3
        return new_state, out, times

    return step


# Kernel launch counters a replay carries over (utils.graphs.Graphs).
KERNEL_COUNTERS = ((klt_kernel.klt_bidir, "launches"),
                   (klt_kernel.klt_bidir, "rot_launches"),
                   (klt_kernel.klt_level, "launches"),
                   (ba_kernel.ba_assemble, "launches"))


class GraphStep:
    """What the compiled steps share (CompiledStep here, CompiledVIOStep in
    models/estimator_vio.py): the segment variants (utils.graphs.Graphs),
    the host mirror of the state's counts, the fixed input buffers, the one
    blocking read of is_kf a frame and the ping-pong output buffers.

    Inputs go into fixed buffers (utils.graphs.Slab): the state (skipped
    when it is the one this step just returned; otherwise the subclass
    reads its mirror from it), the rig (when it is not the object of the
    last call), both images, and the gate's draws, made on the host for the
    mirrored frame id and copied to the card outside the graphs. The first
    segment ends by copying is_kf to pinned host memory and the step waits
    for that copy (`host_reads` counts the waits, one a frame). Results come
    back in one of two output buffers used in turn, so a state and output
    returned by call k stay unchanged through call k + 1 and are overwritten
    by call k + 2: keep a copy of what must live longer.

    On CUDA a failed capture or replay raises utils.graphs.GraphError; the
    step never falls back to eager execution. On the CPU (device="cpu") the
    same segments and buffers run eagerly. `graphs` holds each variant's
    capture time; `last_variants` the variant keys of the last call.
    `counters`: Python counters the window solvers advance (a mesh's
    collective counts), carried over replays with the kernels' launches.

    While the tracer is on (profiling), a call records a ``step`` span
    (attributes: ``step``, this step's `tag`; ``frame``, the mirrored frame
    id; ``ready``, PnP runs; ``is_kf``; ``solve``) and inside it
    ``step.load`` (the inputs, the draws and the IMU buffer into their
    buffers), ``step.read`` (the wait for is_kf) and ``step.emit``, besides
    utils.graphs.Graphs' ``graph.replay`` / ``graph.capture``. On CUDA it
    records a timing event on its stream before and after each replay and
    reads them as ``graph.device`` and ``stream.gap`` records
    (profiling.DeviceSpans) with the variant's ``key`` and its ``layer``:
    ``motion`` (segment M / F) or ``keyframe`` (P and K). ``graph.device``
    includes the launch when the stream was idle at it; ``stream.gap``
    then ends as the launch starts. They are read at the start of a later
    call, once their end has completed. Off, none of this runs: no event is
    made, recorded or read."""

    _tags = itertools.count()

    def __init__(self, cfg: EstimatorConfig, draws, device, maker: str,
                 counters=()):
        self.cfg, self.draws = cfg, draws
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{maker}: no CUDA device is available; pass "
                               "device='cpu' to run the segments eagerly on "
                               "the CPU")
        self.graphs = graph_mod.Graphs(self.device,
                                       KERNEL_COUNTERS + tuple(counters))
        self.host_reads = 0
        self.mirror = None
        self.last_variants = None
        self._in = self._rig = self._img = self._mid = self._new = None
        self._out, self._turn = None, 0
        self._last, self._rig_src = None, None
        self._gumbel = self._gumbel_host = None
        self.pinned = self.device.type == "cuda"
        self._is_kf_host = torch.zeros(1, dtype=torch.bool,
                                       pin_memory=self.pinned)
        self._event = torch.cuda.Event() if self.pinned else None
        self.tag = next(GraphStep._tags)
        self._dev = profiling.DeviceSpans()

    def _step_span(self):
        """The call's ``step`` span, after reading the device spans of
        earlier calls' replays that have completed."""
        if profiling.on():
            self._dev.settle()
        elif self._dev.items or self._dev.prev is not None:
            self._dev.discard()
        return profiling.span("step", step=self.tag)

    def _segment(self, key, fn, layer: str):
        """Run segment variant `key` (utils.graphs.Graphs.run); while the
        tracer is on, a replay runs between two timing events on the step's
        stream, the device spans of `layer`."""
        if not (profiling.on() and self._replays(key)):
            self.graphs.run(key, fn)
            return
        events = tuple(torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        events[0].record()
        self.graphs.run(key, fn)
        events[1].record()
        self._dev.replayed(events, key=key, layer=layer)

    def _replays(self, key) -> bool:
        """Whether running `key` replays a captured graph."""
        return key in self.graphs.graphs

    def _load(self, state, rig, imgs) -> bool:
        """The inputs into their buffers; True when `state` was copied in
        (it is not the one this step returned last)."""
        dev = self.device
        if self._in is None:
            self._in = graph_mod.Slab(state, dev)
            self._rig = graph_mod.Slab(rig, dev)
            self._img = graph_mod.Slab(imgs, dev)
        foreign = state is not self._last
        if foreign:
            self._in.load(state)
        if rig is not self._rig_src:
            self._rig.load(rig)
            self._rig_src = rig
        self._img.load(imgs)
        return foreign

    def _stage_draws(self, frame_id: int):
        """The gate's draws for `frame_id` into the fixed device buffer: made
        on the host, copied on the stream from pinned memory."""
        n = self._in.tree.lm.shape[0]
        dtype = self._in.tree.T_W_B.dtype
        g = self.draws(frame_id, (self.cfg.pnp.ransac_hypotheses, 2 * n),
                       dtype, torch.device("cpu"))
        if self._gumbel is None:
            self._gumbel = torch.empty(g.shape, dtype=dtype,
                                       device=self.device)
            self._gumbel_host = torch.empty(g.shape, dtype=dtype,
                                            pin_memory=self.pinned)
        self._gumbel_host.copy_(g)
        self._gumbel.copy_(self._gumbel_host, non_blocking=True)

    def _keep_mid(self, seg, is_kf):
        """Inside the first segment: its results into their buffer, is_kf
        on its way to pinned host memory."""
        if self._mid is None:
            self._mid = graph_mod.Slab(seg, self.device)
        self._mid.load(seg)
        self._is_kf_host.copy_(is_kf.reshape(1), non_blocking=True)

    def _keep_new(self, res):
        """Inside the second segment: (new state, output) into their
        buffer."""
        if self._new is None:
            self._new = graph_mod.Slab(res, self.device)
            if not self._in.same_prefix(self._new):
                raise ValueError("the step's new state does not have the "
                                 "layout of its input state")
        self._new.load(res)

    def _read_is_kf(self) -> bool:
        """The frame's one blocking read."""
        with profiling.span("step.read"):
            if self._event is not None:
                self._event.record()
                self._event.synchronize()
            self.host_reads += 1
            return bool(self._is_kf_host[0])

    def _emit(self):
        """The new state becomes the next input; (state, output) in the
        next output buffer."""
        with profiling.span("step.emit"):
            if self._out is None:
                self._out = [graph_mod.Slab(self._new.template, self.device)
                             for _ in range(2)]
            self._in.buf.copy_(self._new.buf[:self._in.nbytes])
            self._turn ^= 1
            out = self._out[self._turn]
            out.buf.copy_(self._new.buf)
            new_state, frame_out = out.fresh_tree()
            self._last = new_state
            return new_state, frame_out


class CompiledStep(GraphStep):
    """The per-frame step as CUDA graphs: the port's counterpart of
    ``jax.jit(step)`` (make_compiled_estimator_step builds it; called as
    step(state, rig, img0, img1) -> (state, FrameOutput) with the eager
    step's results).

    Segment M (frames, track, motion) has a variant for each pnp_ready,
    segment K (the keyframe stage) one for no keyframe, a keyframe before
    the window solve engages, and a keyframe with the solve: JAX's three
    lax.conds. The host mirrors what decides them — `mirror` holds the
    next frame's (frame_id, kf_count), from which pnp_ready, full_now and
    the RANSAC draws' seed follow — and reads only is_kf from the device
    (GraphStep). The mirror is read from the state once whenever the step
    is handed a state it did not return last (a first call, a checkpoint's
    state): one more blocking read then. `segments`: the eager step's
    (make_estimator_step's `segments`)."""

    def __init__(self, cfg: EstimatorConfig, draws, device,
                 segments: Segments, counters=()):
        super().__init__(cfg, draws, device, "make_compiled_estimator_step",
                         counters)
        self._sg = segments

    def _motion(self, ready: bool):
        gate = ready and self.cfg.pnp.ransac_hypotheses > 0

        def fn():
            seg = self._sg.motion(self._in.tree, self._rig.tree,
                                  *self._img.tree, ready,
                                  self._gumbel if gate else None)
            self._keep_mid(seg, seg.mo.is_kf)
        return fn

    def _opt(self, is_kf: bool, solve: bool):
        def fn():
            self._keep_new(self._sg.opt(self._in.tree, self._rig.tree,
                                        self._mid.tree, is_kf, solve))
        return fn

    def __call__(self, state: EstimatorState, rig: CameraRig, img0, img1):
        cfg = self.cfg
        with self._step_span() as sp:
            with profiling.span("step.load"):
                if self._load(state, rig, (img0, img1)):
                    kf, fid = torch.stack([
                        state.kf_count.to(torch.int64),
                        state.frame_id.to(torch.int64)]).tolist()
                    self.mirror = (fid, kf)
                fid, kf = self.mirror
                ready = bool(pnp_ready(cfg, kf))
                if ready and cfg.pnp.ransac_hypotheses > 0:
                    self._stage_draws(fid)
            sp.set(frame=fid, ready=ready)
            self._segment(("motion", ready), self._motion(ready), "motion")
            is_kf = self._read_is_kf()
            solve = is_kf and bool(full_now(cfg, kf))
            sp.set(is_kf=is_kf, solve=solve)
            self._segment(("opt", is_kf, solve), self._opt(is_kf, solve),
                          "keyframe")
            self.last_variants = (("motion", ready), ("opt", is_kf, solve))
            self.mirror = (fid + 1,
                           min(kf + 1, cfg.window_size) if is_kf else kf)
            return self._emit()


def make_compiled_estimator_step(cfg: EstimatorConfig, draws=gumbel_draws,
                                 device="cuda", probe=None,
                                 window_solvers=None):
    """The per-frame step (state, rig, img0, img1) -> (state, FrameOutput)
    as CUDA graphs of its segments (CompiledStep): the counterpart of the
    JAX package's ``jax.jit(step)``, with make_estimator_step's results.
    Pins full fp32 and validates the config. `draws` and `window_solvers`
    as in make_estimator_step (`draws` is called with the CPU as its
    device; the solvers' `counters` are carried over replays). `device`:
    "cuda" (the default; raises without a card) or "cpu", where the same
    segments run eagerly. `probe` is refused (ValueError): its counts are
    Python dict updates, which a replay would not run; use
    make_estimator_step for it."""
    if probe is not None:
        raise ValueError("probe counts cannot be replayed from a CUDA graph; "
                         "use make_estimator_step(cfg, probe=...)")
    eager = make_estimator_step(cfg, draws, window_solvers=window_solvers)
    return CompiledStep(cfg, draws, device, eager.segments,
                        getattr(window_solvers, "counters", ()))
