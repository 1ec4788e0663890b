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
``vision_weight_adaptive``, ``health_recover``).

Control flow. The JAX step is one jitted function whose data-dependent
branches are ``lax.cond``s: ``pnp_ready`` in run_motion, ``is_kf`` and
``full_now`` in stage_opt. Here they are host branches on ``bool(tensor)``,
one device sync per branch per frame, as rsvio_tpu/parallel/dist_estimator.py
already does in JAX. The RANSAC gate runs inside the ``pnp_ready`` branch
and reads the frame id (which seeds its draws) in the same sync. Making the
step capturable in a CUDA graph (so these syncs go) is later work (ROADMAP
A10).

Options not ported yet raise ``NotImplementedError`` naming their ROADMAP
item (``check_config``); none is silently ignored.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..ops import cameras, lie, pyramid
from ..ops.projection import triangulate_stereo
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
    """Raise NotImplementedError for every option the port does not
    implement yet, naming its ROADMAP item, and ValueError for incoherent
    or unknown values."""
    todo = [
        (cfg.use_marginalization, "use_marginalization", "A13"),
        (cfg.dynamic_flow_thresh > 0, "dynamic_flow_thresh > 0", "A13"),
        (cfg.refine_births, "refine_births", "A13"),
        (cfg.cull_reproj_threshold > 0, "cull_reproj_threshold > 0", "A13"),
        (cfg.pnp_cv_predict, "pnp_cv_predict", "A13"),
        (not cfg.track_before_full, "track_before_full=False", "A13"),
    ]
    for on, name, item in todo:
        if on:
            raise NotImplementedError(
                f"EstimatorConfig option {name} is not ported yet "
                f"(ROADMAP {item})")
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
    end, lm_birth (the frozen birth-time map the RANSAC gate verifies
    against) and health_ema (the smoothed track health) are allocated when
    the gate is on; the scene-flow gate's memories (not ported) stay
    None."""
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
    landmarks of recycled or dead slots. Returns (lm, lm_fid, born, p):
    born marks the slots triangulated by this call, p is every slot's
    stereo triangulation."""
    T_W_C = T_W_B @ rig.T_B_C                               # (2,4,4)
    p, tri_ok = triangulate_stereo(T_W_C[0], T_W_C[1], obs_cur[0],
                                   obs_cur[1])
    has_lm = (lm_fid == table.fid) & (lm_fid >= 0)
    want = table.alive & (~has_lm) & tri_ok
    lm = torch.where(want[:, None], p, lm)
    lm_fid = torch.where(want, table.fid, lm_fid)
    stale = (lm_fid != table.fid) | (~table.alive)
    lm_fid = torch.where(stale & ~want, torch.full_like(lm_fid, -1), lm_fid)
    return lm, lm_fid, want, p


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


def run_motion(cfg: EstimatorConfig, rig: CameraRig, table, obs_cur,
               obs_cur_mask, lm, lm_fid, lm_birth, kf_count, last_kf_T_W_B,
               frame_id, T_pred, T_gate_seed, T_prior, T_fallback,
               obs_w_slots=None, health_prev=None,
               draws=gumbel_draws) -> MotionOut:
    """PnP motion tracking + keyframe policy: the optional RANSAC pre-gate
    (verified against the frozen birth map lm_birth, hypotheses seeded at
    T_gate_seed, draws from `draws(frame_id, shape, dtype, device)`), the
    track health from its inlier fraction, the LM PnP polish with optional
    score weights obs_w_slots and health-scaled motion prior, the
    numerical-health recovery, the keyframe test and the outlier kill."""
    dev, dtype = T_pred.device, T_pred.dtype
    window_full = kf_count >= cfg.window_size
    pnp_ready = kf_count >= 1      # track_before_full (the only mode ported)

    lm_ok = (lm_fid == table.fid) & (lm_fid >= 0) & table.alive
    pnp_mask = obs_cur_mask & lm_ok[None, :]
    n_pnp = pnp_mask.to(torch.int32).sum(dtype=torch.int32)

    false = torch.tensor(False, device=dev)
    use_ransac = cfg.pnp.ransac_hypotheses > 0
    inl_mask, ransac_ok = pnp_mask, false
    n_inl = torch.tensor(0, dtype=torch.int32, device=dev)
    health = torch.tensor(1.0, dtype=dtype, device=dev)
    # Host branch (JAX: lax.cond on pnp_ready): one sync per frame, which
    # with the gate on also brings the frame id that seeds its draws.
    if use_ransac:
        ready, fid = torch.stack([pnp_ready.to(torch.int64),
                                  frame_id.to(torch.int64)]).tolist()
    else:
        ready = bool(pnp_ready)
    if ready and use_ransac:
        gumbel = draws(fid, (cfg.pnp.ransac_hypotheses, 2 * lm.shape[0]),
                       dtype, dev)
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
        health = torch.where(ransac_ok, ramp, torch.tensor(
            cfg.health_floor, dtype=dtype, device=dev))
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
                        torch.tensor(True, device=dev))

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
    epilogue."""
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
    lm_birth: torch.Tensor    # (N,3) frozen birth map (None: gate off)
    full_now: torch.Tensor    # () bool run BA this keyframe


class Stages(NamedTuple):
    """The per-frame step as named stages (the reference's [Timing] split):
    frames -> frame_creation, track -> patch_tracking, motion ->
    motion_tracking, opt -> optimization."""
    frames: callable
    track: callable
    motion: callable
    opt: callable


def _build_stages(cfg: EstimatorConfig, draws) -> Stages:
    check_config(cfg)
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
                     obs_cur_mask) -> MotionOut:
        # Init from the current (last-optimized) pose; the prior anchor is
        # the measured previous pose.
        return run_motion(
            cfg, rig, table, obs_cur, obs_cur_mask, state.lm, state.lm_fid,
            state.lm_birth, state.kf_count, state.last_kf_T_W_B,
            state.frame_id, T_pred=state.T_W_B, T_gate_seed=state.T_W_B,
            T_prior=state.T_W_B, T_fallback=state.T_W_B,
            obs_w_slots=(effective_weights(cfg, table)
                         if cfg.use_obs_weights else None),
            health_prev=state.health_ema, draws=draws)

    def stage_kf_pre(state: EstimatorState, rig: CameraRig, table, obs_cur,
                     obs_cur_mask, T_cur, health) -> KFPrep:
        """Triangulate new landmarks, FIFO-roll the window, insert the
        frame, build the BA masks. Works on copies; the input state is not
        modified. `state` carries the excised lm_fid."""
        window_full = state.kf_count >= W
        lm, lm_fid, born, tri_all = _triangulate_new(
            rig, T_cur, obs_cur, table, state.lm, state.lm_fid)
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
        full_now = kf_count >= 2       # track_before_full
        eff_mask = obs_m & (obs_f == table.fid[None, :])[:, None, :]
        kf_valid = torch.arange(W, device=kf_count.device) < kf_count
        eff_mask = eff_mask & kf_valid[:, None, None]
        lm_valid = (lm_fid == table.fid) & (lm_fid >= 0)
        return KFPrep(kf_T=kf_T, kf_count=kf_count, obs_w=obs_w,
                      obs_m=obs_m, obs_f=obs_f, obs_wt=obs_wt, lm=lm,
                      lm_fid=lm_fid, eff_mask=eff_mask, lm_valid=lm_valid,
                      lm_birth=lm_birth, full_now=full_now)

    def stage_kf_post(prep: KFPrep, res_T, res_lm, ba_ok):
        kf_T = torch.where(ba_ok, res_T, prep.kf_T)
        lm = torch.where(ba_ok, res_lm, prep.lm)
        last = (torch.clamp(prep.kf_count, max=W) - 1).to(torch.int64)
        T_new = kf_T.index_select(0, last.reshape(1))[0]
        return kf_T, lm, prep.lm_fid, T_new

    def stage_opt(state: EstimatorState, rig: CameraRig, pyr0, pyr1, table,
                  fstats, obs_cur, obs_cur_mask, mo: MotionOut):
        dev = mo.T_cur.device
        T_cur = mo.T_cur
        if cfg.pnp.ransac_hypotheses > 0 and cfg.pnp_ransac_kill:
            table, obs_cur_mask, lm_fid0 = excise_outliers(
                table, obs_cur_mask, state.lm_fid, mo.kill)
            state = state._replace(lm_fid=lm_fid0)
        # Host branch (JAX: lax.cond on is_kf): one sync per frame.
        if bool(mo.is_kf):
            prep = stage_kf_pre(state, rig, table, obs_cur, obs_cur_mask,
                                T_cur, mo.health)
            # Host branch (JAX: lax.cond on full_now): one sync per keyframe.
            if bool(prep.full_now):
                res = ba_mod.solve_ba(
                    prep.kf_T, rig.T_C_B, prep.lm, prep.obs_w, prep.eff_mask,
                    prep.lm_valid, cfg.ba,
                    obs_weight=prep.obs_wt if cfg.use_obs_weights else None)
                res_T, res_lm, ba_ok, ba_it, ba_cost = (
                    res.T_W_B, res.landmarks, res.success, res.iterations,
                    res.final_cost)
            else:
                res_T, res_lm = prep.kf_T, prep.lm
                ba_ok = torch.tensor(False, device=dev)
                ba_it = torch.tensor(0, dtype=torch.int32, device=dev)
                ba_cost = torch.tensor(0.0, dtype=T_cur.dtype, device=dev)
            kf_T, lm, lm_fid, T_new = stage_kf_post(prep, res_T, res_lm,
                                                    ba_ok)
            kf_count, obs_w, obs_m, obs_f, obs_wt, lm_birth = (
                prep.kf_count, prep.obs_w, prep.obs_m, prep.obs_f,
                prep.obs_wt, prep.lm_birth)
            T_out, last_kf = T_new, T_new
        else:
            kf_T, kf_count = state.kf_T_W_B, state.kf_count
            obs_w, obs_m, obs_f, obs_wt = (state.obs, state.obs_mask,
                                           state.obs_fid, state.obs_w)
            lm, lm_fid, lm_birth = state.lm, state.lm_fid, state.lm_birth
            T_out, last_kf = T_cur, state.last_kf_T_W_B
            ba_ok = torch.tensor(False, device=dev)
            ba_it = torch.tensor(0, dtype=torch.int32, device=dev)
            ba_cost = torch.tensor(0.0, dtype=T_cur.dtype, device=dev)

        new_state = EstimatorState(
            table=table, pyr0=pyr0, pyr1=pyr1, kf_T_W_B=kf_T,
            kf_count=kf_count, obs=obs_w, obs_mask=obs_m, obs_fid=obs_f,
            obs_w=obs_wt, lm=lm, lm_fid=lm_fid, marg_prior=state.marg_prior,
            T_W_B=T_out, last_kf_T_W_B=last_kf,
            frame_id=state.frame_id + 1, T_W_B_prev=state.T_W_B,
            lm_birth=lm_birth,
            health_ema=mo.health if state.health_ema is not None else None)
        out = FrameOutput(
            T_W_B=T_out, is_keyframe=mo.is_kf, pnp_success=mo.pnp_success,
            ba_success=ba_ok, ba_iterations=ba_it, ba_final_cost=ba_cost,
            n_tracked=fstats["tracked"],
            n_landmarks=((lm_fid == table.fid) & (lm_fid >= 0))
            .to(torch.int32).sum(dtype=torch.int32),
            n_alive=fstats["alive"], pose_ok=mo.pose_ok,
            n_dyn_killed=torch.tensor(0, dtype=torch.int32, device=dev),
            n_ransac_inliers=mo.n_inliers, n_pnp_candidates=mo.n_pnp,
            health=mo.health)
        return new_state, out

    return Stages(frames=stage_frames, track=stage_track,
                  motion=stage_motion, opt=stage_opt)


def make_estimator_step(cfg: EstimatorConfig, draws=gumbel_draws):
    """Build the per-frame step (state, rig, img0, img1) -> (state, out).
    Pins full fp32 (``utils.precision.pin_fp32``) and validates the config
    when called. `draws(frame_id, shape, dtype, device)` gives the RANSAC
    gate's Gumbel draws (tests pass the JAX package's)."""
    pin_fp32()
    st = _build_stages(cfg, draws)

    def step(state: EstimatorState, rig: CameraRig, img0, img1):
        pyr0, pyr1 = st.frames(img0, img1)
        table, fstats, obs_cur, obs_cur_mask = st.track(state, rig, pyr0,
                                                        pyr1)
        mo = st.motion(state, rig, table, obs_cur, obs_cur_mask)
        return st.opt(state, rig, pyr0, pyr1, table, fstats, obs_cur,
                      obs_cur_mask, mo)

    return step


STAGE_NAMES = ("frame_creation", "patch_tracking", "motion_tracking",
               "optimization")


def make_estimator_split_step(cfg: EstimatorConfig, draws=gumbel_draws):
    """The step with a synchronized per-stage split: returns
    step(state, rig, img0, img1) -> (state, out, times_ms) with times_ms a
    dict over STAGE_NAMES. Same stages and results as
    make_estimator_step; the syncs make it slower, so use it for diagnosis.
    """
    pin_fp32()
    st = _build_stages(cfg, draws)

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
        mo = st.motion(state, rig, tr[0], tr[2], tr[3])
        sync(dev)
        t3 = time.perf_counter()
        new_state, out = st.opt(state, rig, pyr0, pyr1, *tr, mo)
        sync(dev)
        t4 = time.perf_counter()
        for name, a, b in zip(STAGE_NAMES, (t0, t1, t2, t3), (t1, t2, t3, t4)):
            times[name] = (b - a) * 1e3
        return new_state, out, times

    return step
