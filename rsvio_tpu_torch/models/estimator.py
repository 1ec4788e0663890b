"""Estimator: the per-frame stereo VO step — frontend tracking, PnP motion
tracking, keyframe policy, sliding-window roll, triangulation and BA.

Port of rsvio_tpu/models/estimator.py for the default configuration. The
step is built from the same named stages (frames, track, motion, opt) and
keeps the JAX layouts: poses (4,4), window observations (W,2,N,2), masks
(W,2,N), landmarks slot-aligned with the feature table.

Control flow. The JAX step is one jitted function whose data-dependent
branches are ``lax.cond``s: ``pnp_ready`` in run_motion, ``is_kf`` and
``full_now`` in stage_opt. Here they are host branches on ``bool(tensor)``,
one device sync per branch per frame, as rsvio_tpu/parallel/dist_estimator.py
already does in JAX. Making the step capturable in a CUDA graph (so these
syncs go) is later work (ROADMAP A10).

Options that are off by default and not ported yet raise
``NotImplementedError`` naming their ROADMAP item (``check_config``); none is
silently ignored.
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


def check_config(cfg: EstimatorConfig) -> None:
    """Raise NotImplementedError for every option the port does not
    implement yet, naming its ROADMAP item."""
    todo = [
        (cfg.use_marginalization, "use_marginalization", "A13"),
        (cfg.pnp.ransac_hypotheses > 0, "pnp.ransac_hypotheses > 0", "A13"),
        (cfg.dynamic_flow_thresh > 0, "dynamic_flow_thresh > 0", "A13"),
        (cfg.refine_births, "refine_births", "A13"),
        (cfg.cull_reproj_threshold > 0, "cull_reproj_threshold > 0", "A13"),
        (cfg.use_obs_weights, "use_obs_weights", "A13"),
        (cfg.pnp_cv_predict, "pnp_cv_predict", "A13"),
        (cfg.pnp_prior_adaptive, "pnp_prior_adaptive", "A13"),
        (cfg.vision_weight_adaptive, "vision_weight_adaptive", "A13"),
        (cfg.health_recover < 1.0, "health_recover < 1", "A13"),
        (cfg.obs_weight_age_ramp > 0, "obs_weight_age_ramp > 0", "A13"),
        (not cfg.track_before_full, "track_before_full=False", "A13"),
    ]
    for on, name, item in todo:
        if on:
            raise NotImplementedError(
                f"EstimatorConfig option {name} is not ported yet "
                f"(ROADMAP {item})")
    if cfg.cam_kind_l.lower() == cameras.EUCM or \
            cfg.cam_kind_r.lower() == cameras.EUCM:
        raise NotImplementedError(
            "EUCM camera model is not ported yet (ROADMAP A3)")
    frontend_mod.check_config(cfg.frontend)


class CameraRig(NamedTuple):
    params: torch.Tensor   # (2, 10) packed intrinsics
    T_C_B: torch.Tensor    # (2, 4, 4) camera-from-body
    T_B_C: torch.Tensor    # (2, 4, 4) body-from-camera


def make_rig(params_l, params_r, T_B_Cl, T_B_Cr) -> CameraRig:
    T_B_C = torch.stack([T_B_Cl, T_B_Cr])
    return CameraRig(params=torch.stack([params_l, params_r]),
                     T_C_B=lie.se3_inverse(T_B_C), T_B_C=T_B_C)


class EstimatorState(NamedTuple):
    """Same fields as the JAX EstimatorState. The optional gate memories at
    the end belong to options not ported yet and stay None."""
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
    landmarks of recycled or dead slots. Returns (lm, lm_fid)."""
    T_W_C = T_W_B @ rig.T_B_C                               # (2,4,4)
    p, tri_ok = triangulate_stereo(T_W_C[0], T_W_C[1], obs_cur[0],
                                   obs_cur[1])
    has_lm = (lm_fid == table.fid) & (lm_fid >= 0)
    want = table.alive & (~has_lm) & tri_ok
    lm = torch.where(want[:, None], p, lm)
    lm_fid = torch.where(want, table.fid, lm_fid)
    stale = (lm_fid != table.fid) | (~table.alive)
    lm_fid = torch.where(stale & ~want, torch.full_like(lm_fid, -1), lm_fid)
    return lm, lm_fid


class MotionOut(NamedTuple):
    T_cur: torch.Tensor        # (4,4) pose after PnP + health gate
    pnp_success: torch.Tensor  # () bool (includes pose_ok)
    is_kf: torch.Tensor        # () bool
    pose_ok: torch.Tensor      # () bool numerical-health flag
    n_pnp: torch.Tensor        # () int32 PnP candidate observations


def run_motion(cfg: EstimatorConfig, rig: CameraRig, table, obs_cur,
               obs_cur_mask, lm, lm_fid, kf_count, last_kf_T_W_B, T_pred,
               T_prior, T_fallback) -> MotionOut:
    """PnP motion tracking + keyframe policy (no RANSAC gate)."""
    dev = T_pred.device
    window_full = kf_count >= cfg.window_size
    pnp_ready = kf_count >= 1      # track_before_full (the only mode ported)

    lm_ok = (lm_fid == table.fid) & (lm_fid >= 0) & table.alive
    pnp_mask = obs_cur_mask & lm_ok[None, :]
    n_pnp = pnp_mask.to(torch.int32).sum(dtype=torch.int32)

    # Host branch (JAX: lax.cond on pnp_ready): one sync per frame.
    if bool(pnp_ready):
        res = pnp_mod.solve_pnp(T_pred, rig.T_C_B, lm, obs_cur, pnp_mask,
                                cfg.pnp, T_W_B_prior=T_prior)
        T_pnp, pnp_success = res.T_W_B, res.success
    else:
        T_pnp, pnp_success = T_fallback, torch.tensor(False, device=dev)
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
    return MotionOut(T_cur=T_cur, pnp_success=pnp_success & pose_ok,
                     is_kf=is_kf, pose_ok=pose_ok, n_pnp=n_pnp)


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
    full_now: torch.Tensor    # () bool run BA this keyframe


class Stages(NamedTuple):
    """The per-frame step as named stages (the reference's [Timing] split):
    frames -> frame_creation, track -> patch_tracking, motion ->
    motion_tracking, opt -> optimization."""
    frames: callable
    track: callable
    motion: callable
    opt: callable


def _build_stages(cfg: EstimatorConfig) -> Stages:
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
        return run_motion(cfg, rig, table, obs_cur, obs_cur_mask, state.lm,
                          state.lm_fid, state.kf_count, state.last_kf_T_W_B,
                          T_pred=state.T_W_B, T_prior=state.T_W_B,
                          T_fallback=state.T_W_B)

    def stage_kf_pre(state: EstimatorState, rig: CameraRig, table, obs_cur,
                     obs_cur_mask, T_cur) -> KFPrep:
        """Triangulate new landmarks, FIFO-roll the window, insert the
        frame, build the BA masks. Works on copies; the input state is not
        modified."""
        window_full = state.kf_count >= W
        lm, lm_fid = _triangulate_new(rig, T_cur, obs_cur, table, state.lm,
                                      state.lm_fid)
        obs_cur_mask_eff = obs_cur_mask & table.alive[None, :]
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
        obs_wt = roll_insert(state.obs_w, table.w)
        kf_count = torch.clamp(state.kf_count + 1, max=W)
        full_now = kf_count >= 2       # track_before_full
        eff_mask = obs_m & (obs_f == table.fid[None, :])[:, None, :]
        kf_valid = torch.arange(W, device=kf_count.device) < kf_count
        eff_mask = eff_mask & kf_valid[:, None, None]
        lm_valid = (lm_fid == table.fid) & (lm_fid >= 0)
        return KFPrep(kf_T=kf_T, kf_count=kf_count, obs_w=obs_w,
                      obs_m=obs_m, obs_f=obs_f, obs_wt=obs_wt, lm=lm,
                      lm_fid=lm_fid, eff_mask=eff_mask, lm_valid=lm_valid,
                      full_now=full_now)

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
        # Host branch (JAX: lax.cond on is_kf): one sync per frame.
        if bool(mo.is_kf):
            prep = stage_kf_pre(state, rig, table, obs_cur, obs_cur_mask,
                                T_cur)
            # Host branch (JAX: lax.cond on full_now): one sync per keyframe.
            if bool(prep.full_now):
                res = ba_mod.solve_ba(prep.kf_T, rig.T_C_B, prep.lm,
                                      prep.obs_w, prep.eff_mask,
                                      prep.lm_valid, cfg.ba)
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
            kf_count, obs_w, obs_m, obs_f, obs_wt = (
                prep.kf_count, prep.obs_w, prep.obs_m, prep.obs_f,
                prep.obs_wt)
            T_out, last_kf = T_new, T_new
        else:
            kf_T, kf_count = state.kf_T_W_B, state.kf_count
            obs_w, obs_m, obs_f, obs_wt = (state.obs, state.obs_mask,
                                           state.obs_fid, state.obs_w)
            lm, lm_fid = state.lm, state.lm_fid
            T_out, last_kf = T_cur, state.last_kf_T_W_B
            ba_ok = torch.tensor(False, device=dev)
            ba_it = torch.tensor(0, dtype=torch.int32, device=dev)
            ba_cost = torch.tensor(0.0, dtype=T_cur.dtype, device=dev)

        new_state = EstimatorState(
            table=table, pyr0=pyr0, pyr1=pyr1, kf_T_W_B=kf_T,
            kf_count=kf_count, obs=obs_w, obs_mask=obs_m, obs_fid=obs_f,
            obs_w=obs_wt, lm=lm, lm_fid=lm_fid, marg_prior=state.marg_prior,
            T_W_B=T_out, last_kf_T_W_B=last_kf,
            frame_id=state.frame_id + 1, T_W_B_prev=state.T_W_B)
        out = FrameOutput(
            T_W_B=T_out, is_keyframe=mo.is_kf, pnp_success=mo.pnp_success,
            ba_success=ba_ok, ba_iterations=ba_it, ba_final_cost=ba_cost,
            n_tracked=fstats["tracked"],
            n_landmarks=((lm_fid == table.fid) & (lm_fid >= 0))
            .to(torch.int32).sum(dtype=torch.int32),
            n_alive=fstats["alive"], pose_ok=mo.pose_ok,
            n_dyn_killed=torch.tensor(0, dtype=torch.int32, device=dev),
            n_ransac_inliers=torch.tensor(0, dtype=torch.int32, device=dev),
            n_pnp_candidates=mo.n_pnp,
            health=torch.tensor(1.0, dtype=T_cur.dtype, device=dev))
        return new_state, out

    return Stages(frames=stage_frames, track=stage_track,
                  motion=stage_motion, opt=stage_opt)


def make_estimator_step(cfg: EstimatorConfig):
    """Build the per-frame step (state, rig, img0, img1) -> (state, out).
    Pins full fp32 (``utils.precision.pin_fp32``) and validates the config
    when called."""
    pin_fp32()
    st = _build_stages(cfg)

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


def make_estimator_split_step(cfg: EstimatorConfig):
    """The step with a synchronized per-stage split: returns
    step(state, rig, img0, img1) -> (state, out, times_ms) with times_ms a
    dict over STAGE_NAMES. Same stages and results as
    make_estimator_step; the syncs make it slower, so use it for diagnosis.
    """
    pin_fp32()
    st = _build_stages(cfg)

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
