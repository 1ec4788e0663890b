"""Visual-inertial sliding-window BA: 15-dim keyframe states
[pose(6) | velocity(3) | gyro bias(3) | accel bias(3)] with IMU
preintegration factors chaining consecutive keyframes, joined to the stereo
reprojection system and solved by damped Schur-complement LM.

Port of rsvio_tpu/models/vio_ba.py: ``solve_vio_ba``, the marginalized
``solve_vio_ba_marginalized`` with ``build_eviction_prior``, and their
factor pieces. The same design:
  * reprojection factors touch only the pose sub-block (first 6 dims) of a
    state, so the landmark elimination runs in the 6-dim pose subspace;
  * IMU factors touch two consecutive states; their Jacobians are the
    forward-mode derivatives of the whitened residual along the 30
    increment directions (JAX: ``jax.jacfwd``, vmapped over the intervals),
    here carried through the residual's chain by hand for every interval
    of the window at once (_imu_linearize);
  * gauge: the first pose (6 dims) fixed, its velocity and biases free.

The LM loop takes models/ba.py's ``reduce`` hook (the identity on one
device; parallel.dist_vio_ba passes the mesh's all-reduce): the visual
pose blocks and cost, the 6-dim Schur system, the step's vote and metric
pieces, the regate's counts, the observability counts and the finiteness
vote are reduced over landmark shards; the IMU and prior terms live on the
(replicated) states and are not.

Differences of form, same results, as in models/ba.py: a fixed-trip LM
loop that freezes its carry once done (no host sync inside the solve), the
chi^2 regate computed every iteration and selected on the device, and
Cholesky / inverse failures carried as NaN (``cholesky_ex``, ``inv_ex``)
where ``torch.linalg`` would raise. The regate's visual blocks come from
the same ``ops.cuda.ba_kernel.ba_assemble`` pass as the iteration's (the
mask only zeroes terms of the linearization), and it reuses the
iteration's IMU and prior terms, which do not depend on the mask: the same
system JAX builds by linearizing again.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie
from ..ops.cuda.ba_kernel import ba_assemble
from ..ops.projection import linearize_projection
from . import ba as ba_mod
from .imu import GRAVITY, Preintegrated, imu_residual
from .marginalization import MargPrior, marginalize_oldest, prior_terms

D = 15  # state dim per keyframe


class VIOBAConfig(NamedTuple):
    """Same fields and defaults as the JAX VIOBAConfig (see
    rsvio_tpu/models/vio_ba.py for the measurements behind each one)."""
    max_iterations: int = 20
    huber_delta: float = 2.0
    cost_tol: float = 1e-6
    param_tol: float = 1e-9
    lambda_init: float = 1e-4
    lambda_max: float = 1e8
    min_residual_blocks: int = 6
    chi2_gate: float = 0.0
    chi2_gate_iter: int = 1
    min_lm_span: int = 1
    prior_decay: float = 0.7
    prior_drop_bias: bool = True
    prior_velocity_bias_only: bool = False
    prior_visual_anchor: bool = True
    bias_gyro_weight: float = 1e3    # sqrt-info of the bias random walks
    bias_accel_weight: float = 1e2
    bias_gyro_weight_desert: float = 0.0
    bias_accel_weight_desert: float = 0.0
    imu_weight_cap: float = 3e2


class VIOState(NamedTuple):
    """Per-window VIO variables (W leading dim)."""
    T_W_B: torch.Tensor   # (W,4,4)
    vel: torch.Tensor     # (W,3)
    bg: torch.Tensor      # (W,3)
    ba: torch.Tensor      # (W,3)


class VIOBAResult(NamedTuple):
    state: VIOState
    landmarks: torch.Tensor
    success: torch.Tensor
    status: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor
    metrics: torch.Tensor = None  # (max_iterations, ba.N_METRIC_COLS)


def _retract_state(st: VIOState, delta):
    """delta (W, 15) -> retracted VIOState: the split retraction on T_B_W
    for the pose (the reprojection Jacobians' tangent), additive velocity
    and biases."""
    T_B_W = lie.se3_retract_split(lie.se3_inverse(st.T_W_B), delta[:, :6])
    return VIOState(T_W_B=lie.se3_inverse(T_B_W),
                    vel=st.vel + delta[:, 6:9], bg=st.bg + delta[:, 9:12],
                    ba=st.ba + delta[:, 12:15])


def _imu_sqrt_info(pre: Preintegrated, cfg: VIOBAConfig):
    """Scaled sqrt-information (..., 9, 9) of the [dR, dv, dp] block:
    chol(inv(cov + 1e-10 I))^T, rescaled uniformly so its largest entry is
    at most cfg.imu_weight_cap. NaN where the inverse or the Cholesky
    factor does not exist (JAX's result there)."""
    cov = pre.cov + 1e-10 * torch.eye(9, dtype=pre.cov.dtype,
                                      device=pre.cov.device)
    inv, info = torch.linalg.inv_ex(cov)
    L, info_c = torch.linalg.cholesky_ex(inv)
    ok = ((info == 0) & (info_c == 0))[..., None, None]
    L = torch.where(ok, L, torch.full_like(L, torch.nan))
    scale = torch.clamp(cfg.imu_weight_cap / torch.clamp(
        L.abs().amax(dim=(-2, -1)), min=1e-12), max=1.0)
    return L.transpose(-1, -2) * scale[..., None, None]


def _imu_whitened_residual(pre: Preintegrated, st_i, st_j, cfg: VIOBAConfig,
                           sqrt_info=None, bias_scale=None):
    """Whitened 15-dim IMU residual between state tuples (T_W_B, v, bg, ba)
    (leading batch dims allowed). bias_scale: optional (..., 2) multipliers
    of the gyro / accel bias random-walk rows (bias_desert_scales)."""
    r = imu_residual(pre, *st_i, *st_j)
    if sqrt_info is None:
        sqrt_info = _imu_sqrt_info(pre, cfg)
    r9 = (sqrt_info @ r[..., :9, None])[..., 0]
    r_bg = r[..., 9:12] * cfg.bias_gyro_weight
    r_ba = r[..., 12:15] * cfg.bias_accel_weight
    if bias_scale is not None:
        r_bg = r_bg * bias_scale[..., 0:1]
        r_ba = r_ba * bias_scale[..., 1:2]
    return torch.cat([r9, r_bg, r_ba], dim=-1)


def bias_desert_scales(cfg: VIOBAConfig, bias_alpha, dtype):
    """Per-interval (gyro, accel) bias-link multipliers (W-1, 2) from the
    desert factors bias_alpha (W-1,) in [0, 1], interpolated in log space
    between the base (0) and the desert (1) stiffness; None when off."""
    if (bias_alpha is None or cfg.bias_gyro_weight_desert <= 0.0
            or cfg.bias_accel_weight_desert <= 0.0):
        return None
    a = torch.clamp(bias_alpha.to(dtype), 0.0, 1.0)
    gs = (cfg.bias_gyro_weight_desert / cfg.bias_gyro_weight) ** a
    as_ = (cfg.bias_accel_weight_desert / cfg.bias_accel_weight) ** a
    return torch.stack([gs, as_], dim=1)


def _so3_exp_jvp(w, dw):
    """so3_exp(w) (..., 3, 3) and its directional derivatives along dw
    (K, ..., 3): the derivative of ops.lie.so3_exp as written (Taylor
    coefficients below its threshold), as forward-mode autodiff gives it."""
    ts = (w * w).sum(-1)
    small = ts < lie._EPS
    ts_s = torch.where(small, torch.ones_like(ts), ts)
    th = torch.sqrt(ts_s)
    sin, cos = torch.sin(th), torch.cos(th)
    a = torch.where(small, 1.0 - ts / 6.0, sin / th)
    b = torch.where(small, 0.5 - ts / 24.0, (1.0 - cos) / ts_s)
    dts = 2.0 * (w * dw).sum(-1)                              # (K, ...)
    # d/dts of sin(th)/th and (1 - cos th)/th^2, th = sqrt(ts).
    da_dts = torch.where(small, torch.full_like(ts, -1.0 / 6.0),
                         (th * cos - sin) / (2.0 * th * ts_s))
    db_dts = torch.where(small, torch.full_like(ts, -1.0 / 24.0),
                         sin / (2.0 * th * ts_s) - (1.0 - cos) / (ts_s * ts_s))
    W, dW = lie.so3_hat(w), lie.so3_hat(dw)
    WW = W @ W
    R = torch.eye(3, dtype=w.dtype, device=w.device) + a[..., None, None] * W \
        + b[..., None, None] * WW
    dR = ((da_dts * dts)[..., None, None] * W + a[..., None, None] * dW
          + (db_dts * dts)[..., None, None] * WW
          + b[..., None, None] * (dW @ W + W @ dW))
    return R, dR


def _so3_log_jvp(M, dM):
    """so3_log(M) (..., 3) and its directional derivatives along dM
    (K, ..., 3, 3), as forward-mode autodiff of ops.lie.so3_log gives them
    (the cosine's clamp passes no derivative outside its bounds, half of
    it on a bound, as jnp.clip's)."""
    lo, hi = -1.0 + 1e-7, 1.0 - 1e-7
    x = (M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2] - 1.0) * 0.5
    c = torch.clamp(x, lo, hi)
    dx = (dM[..., 0, 0] + dM[..., 1, 1] + dM[..., 2, 2]) * 0.5
    pass_ = torch.where((x > lo) & (x < hi), torch.ones_like(x),
                        torch.where((x == lo) | (x == hi),
                                    torch.full_like(x, 0.5),
                                    torch.zeros_like(x)))
    th = torch.arccos(c)
    dth = -(dx * pass_) / torch.sqrt(1.0 - c * c)
    ts = th * th
    small = ts < lie._EPS
    sin = torch.where(small, torch.ones_like(th), torch.sin(th))
    factor = torch.where(small, 0.5 + ts / 12.0, th / (2.0 * sin))
    dfactor = torch.where(small, 2.0 * th * dth / 12.0,
                          dth * (sin - th * torch.cos(th)) / (2.0 * sin * sin))

    def vee(A):
        return torch.stack([A[..., 2, 1] - A[..., 1, 2],
                            A[..., 0, 2] - A[..., 2, 0],
                            A[..., 1, 0] - A[..., 0, 1]], dim=-1)

    v = vee(M)
    return factor[..., None] * v, dfactor[..., None] * v \
        + factor[..., None] * vee(dM)


def _imu_linearize(pre: Preintegrated, Ti, Tj, vi, vj, bgi, bgj, bai, baj,
                   cfg: VIOBAConfig, sqrt_info, bias_scale=None):
    """Residuals and Jacobians of a batch of IMU factors (B intervals):
    r (B, 15), J_i, J_j (B, 15, 15), w.r.t. the [pose (6, T_B_W split
    retraction), v, bg, ba] increments of _retract_state.

    Forward mode by hand along the 30 increment directions at once (a
    leading dim K = 30 on every tangent): the chain rule through the
    retraction, the bias correction, so3_exp / so3_log as written and the
    whitening, which is what JAX's jax.jacfwd of the same residual
    computes. (torch.func's jvp under vmap gives the same numbers at ~50x
    the host cost of the residual itself.) The residual is the one JAX
    evaluates at zero increments, through the retraction's round trip."""
    dt_, dev = Ti.dtype, Ti.device
    B = Ti.shape[0]
    K = 2 * D
    T_B_Wi, T_B_Wj = lie.se3_inverse(Ti), lie.se3_inverse(Tj)
    zero6 = torch.zeros((B, 6), dtype=dt_, device=dev)
    Ti0 = lie.se3_inverse(lie.se3_retract_split(T_B_Wi, zero6))
    Tj0 = lie.se3_inverse(lie.se3_retract_split(T_B_Wj, zero6))
    r = _imu_whitened_residual(pre, (Ti0, vi, bgi, bai), (Tj0, vj, bgj, baj),
                               cfg, sqrt_info, bias_scale)

    # Tangents of the states along the K directions: state i's increments
    # are directions 0..14, state j's 15..29, each [dt, dw, dv, dbg, dba].
    E = torch.eye(3, dtype=dt_, device=dev)
    hatE = lie.so3_hat(E)                                     # (3,3,3)
    zm = torch.zeros((3, B, 3, 3), dtype=dt_, device=dev)
    zv = torch.zeros((3, B, 3), dtype=dt_, device=dev)
    Ev = E[:, None, :].expand(3, B, 3)

    def state_tangents(T0, T_B_W, first):
        R, t_bw = T0[:, :3, :3], T_B_W[:, :3, 3]
        dR_w = -(hatE[:, None] @ R[None])                     # (3,B,3,3)
        dp_w = (hatE[:, None] @ (R @ t_bw[..., None])[None])[..., 0]
        dp_t = -(R[None] @ E[:, None, :, None])[..., 0]       # (3,B,3)
        dR = torch.cat([zm, dR_w, zm, zm, zm])                # (15,B,3,3)
        dp = torch.cat([dp_t, dp_w, zv, zv, zv])
        dv = torch.cat([zv, zv, Ev, zv, zv])
        dbg = torch.cat([zv, zv, zv, Ev, zv])
        dba = torch.cat([zv, zv, zv, zv, Ev])
        other = [torch.zeros_like(x) for x in (dR, dp, dv, dbg, dba)]
        mine = [dR, dp, dv, dbg, dba]
        return [torch.cat([m, o] if first else [o, m]) for m, o in
                zip(mine, other)]                              # (K,B,...)

    dRi, dpi, dvi, dbgi, dbai = state_tangents(Ti0, T_B_Wi, True)
    dRj, dpj, dvj, dbgj, dbaj = state_tangents(Tj0, T_B_Wj, False)

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    g = torch.eye(3, dtype=dt_, device=dev)[2] * -GRAVITY
    Ri, pi_ = Ti0[:, :3, :3], Ti0[:, :3, 3]
    Rj, pj = Tj0[:, :3, :3], Tj0[:, :3, 3]
    dt = pre.dt[..., None]
    dbg = bgi - pre.bias_gyro
    dba = bai - pre.bias_accel
    phi = mv(pre.dR_dbg, dbg)
    E1, dE1 = _so3_exp_jvp(phi, mv(pre.dR_dbg, dbgi))
    Rc = pre.dR @ E1
    dRc = pre.dR @ dE1
    RiT = Ri.transpose(-1, -2)
    RiRj = RiT @ Rj
    M = Rc.transpose(-1, -2) @ RiRj
    dM = dRc.transpose(-1, -2) @ RiRj \
        + Rc.transpose(-1, -2) @ (dRi.transpose(-1, -2) @ Rj + RiT @ dRj)
    _, d_rR = _so3_log_jvp(M, dM)
    u = vj - vi - g * dt
    d_rv = mv(dRi.transpose(-1, -2), u) + mv(RiT, dvj - dvi) \
        - mv(pre.dv_dbg, dbgi) - mv(pre.dv_dba, dbai)
    w = pj - pi_ - vi * dt - 0.5 * g * dt * dt
    d_rp = mv(dRi.transpose(-1, -2), w) + mv(RiT, dpj - dpi - dvi * dt) \
        - mv(pre.dp_dbg, dbgi) - mv(pre.dp_dba, dbai)
    d_r9 = mv(sqrt_info, torch.cat([d_rR, d_rv, d_rp], dim=-1))
    d_bg = (dbgj - dbgi) * cfg.bias_gyro_weight
    d_ba = (dbaj - dbai) * cfg.bias_accel_weight
    if bias_scale is not None:
        d_bg = d_bg * bias_scale[..., 0:1]
        d_ba = d_ba * bias_scale[..., 1:2]
    J = torch.cat([d_r9, d_bg, d_ba], dim=-1).permute(1, 2, 0)  # (B,15,30)
    return r, J[..., :D], J[..., D:]


def _imu_linearize_one(pre: Preintegrated, st: VIOState, i: int,
                       cfg: VIOBAConfig, sqrt_info=None, bias_scale=None):
    """Residual (15,) and Jacobians J_i, J_j (15, 15) of the IMU factor
    between keyframes i and i+1 (pre: that interval's, unbatched)."""
    pre1 = Preintegrated(*(x[None] for x in pre))
    if sqrt_info is None:
        sqrt_info = _imu_sqrt_info(pre1, cfg)
    else:
        sqrt_info = sqrt_info[None]
    r, J_i, J_j = _imu_linearize(
        pre1, st.T_W_B[i:i + 1], st.T_W_B[i + 1:i + 2], st.vel[i:i + 1],
        st.vel[i + 1:i + 2], st.bg[i:i + 1], st.bg[i + 1:i + 2],
        st.ba[i:i + 1], st.ba[i + 1:i + 2], cfg, sqrt_info,
        None if bias_scale is None else bias_scale[None])
    return r[0], J_i[0], J_j[0]


def _extra(st: VIOState):
    return torch.cat([st.vel, st.bg, st.ba], dim=1)          # (W,9)


def _solve(state: VIOState, T_C_B, landmarks, obs, obs_mask, lm_valid,
           preint: Preintegrated, preint_valid, cfg: VIOBAConfig,
           fix_first: bool, obs_weight, bias_alpha, prior,
           reduce=ba_mod.local_reduce):
    """The LM solve shared by solve_vio_ba (prior None) and
    solve_vio_ba_marginalized, and by their landmark-sharded versions
    (`reduce`: the module docstring). Returns (VIOBAResult, final
    observation mask, sqrt-informations)."""
    W = state.T_W_B.shape[0]
    dtype, dev = state.T_W_B.dtype, state.T_W_B.device
    b_scales = bias_desert_scales(cfg, bias_alpha, dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    ar = torch.arange(W, device=dev)
    idx = ar[:-1]
    gauge = torch.cat([torch.zeros(6, dtype=dtype, device=dev),
                       torch.ones(W * D - 6, dtype=dtype, device=dev)])
    n_imu = preint_valid.sum()

    lm_active0 = ba_mod.lm_span_gate(
        ba_mod.stereo_observability_mask(obs_mask, lm_valid), obs_mask,
        cfg.min_lm_span)
    mask0 = obs_mask & lm_active0[None, None, :]
    # Under-constrained refusal: residual rows (2 per visual block, 15 per
    # IMU interval) must cover the free variables.
    n_vis0, n_act0 = reduce(mask0.sum(), lm_active0.sum())
    attempt = ((n_vis0 + n_imu >= cfg.min_residual_blocks)
               & (2 * n_vis0 + 15 * n_imu >= W * D - 6 + 3 * n_act0))

    # Whitening depends only on the fixed preintegration: once per solve.
    sqrt_infos = _imu_sqrt_info(preint, cfg)
    wv = preint_valid.to(dtype)

    def state_terms(st: VIOState):
        """IMU blocks (and the prior's terms) at st: they do not depend
        on the observation mask."""
        r, J_i, J_j = _imu_linearize(
            preint, st.T_W_B[:-1], st.T_W_B[1:], st.vel[:-1], st.vel[1:],
            st.bg[:-1], st.bg[1:], st.ba[:-1], st.ba[1:], cfg, sqrt_infos,
            b_scales)
        w = wv[:, None, None]
        JiT, JjT = J_i.transpose(-1, -2), J_j.transpose(-1, -2)
        imu = (w * (JiT @ J_i), w * (JjT @ J_j), w * (JiT @ J_j),
               w[..., 0] * (JiT @ r[..., None])[..., 0],
               w[..., 0] * (JjT @ r[..., None])[..., 0],
               (0.5 * wv * (r * r).sum(-1)).sum())
        pr = (prior_terms(prior, st.T_W_B, _extra(st))
              if prior is not None else None)
        return imu, pr

    def visual(st: VIOState, lms, mask, chi2_gate=0.0):
        return ba_assemble(lie.se3_inverse(st.T_W_B), T_C_B, lms, obs, mask,
                           obs_weight, lm_valid, cfg.huber_delta, chi2_gate)

    def assemble(b, terms, lm_active):
        """The undamped system (H_ss (W,W,D,D), H_ll, H_pl6, g_s, g_l) and
        the total cost, from the visual blocks b and the state terms."""
        (Hii, Hjj, Hij, gi, gj, imu_cost), pr = terms
        H_pp6, g_p6, vis = reduce(b.H_pp, b.g_p, b.cost)
        H_ss = torch.zeros((W, W, D, D), dtype=dtype, device=dev)
        H_ss[ar, ar, :6, :6] = H_pp6
        g_s = torch.zeros((W, D), dtype=dtype, device=dev)
        g_s[:, :6] = g_p6
        H_ss[idx, idx] += Hii
        H_ss[idx + 1, idx + 1] += Hjj
        H_ss[idx, idx + 1] += Hij
        H_ss[idx + 1, idx] += Hij.transpose(-1, -2)
        g_s[idx] += gi
        g_s[idx + 1] += gj
        cost = vis + imu_cost
        if pr is not None:
            H_add, g_add, pcost = pr
            H_ss = (H_ss.permute(0, 2, 1, 3).reshape(W * D, W * D) + H_add) \
                .reshape(W, D, W, D).permute(0, 2, 1, 3)
            g_s = (g_s.reshape(W * D) + g_add).reshape(W, D)
            cost = cost + pcost
        g_l_m = torch.where(lm_active[:, None], b.g_l, zero)
        H_pl6_m = torch.where(lm_active[None, :, None, None], b.H_pl, zero)
        return (H_ss, b.H_ll, H_pl6_m, g_s, g_l_m), cost

    def block_diag(H_ss):
        return torch.clamp(torch.diagonal(H_ss[ar, ar], dim1=-2, dim2=-1),
                           min=1e-8)                            # (W,D)

    def step(sys, lam, lm_active):
        """Damp, reduce and solve: (delta_s (W,D), delta_l (L,3), delta_s
        finite, this shard's landmark step valid)."""
        H_ss, H_ll, H_pl6, g_s, g_l = sys
        H_ss = H_ss.clone()
        H_ss[ar, ar] += lam * torch.diag_embed(block_diag(H_ss))
        H_ll_d = H_ll + lam * torch.diag_embed(ba_mod._clamped_diag(H_ll))
        H_ll_d = torch.where(lm_active[:, None, None], H_ll_d, eye3)
        H_ll_inv, inv_ok = ba_mod._inv3x3(H_ll_d)
        A6 = torch.einsum("wlij,ljk->wlik", H_pl6, H_ll_inv)   # (W,L,6,3)
        S6, b6 = reduce(torch.einsum("wlik,vljk->wvij", A6, H_pl6),
                        torch.einsum("wlik,lk->wi", A6, g_l))  # (W,W,6,6)
        H_ss[:, :, :6, :6] -= S6
        b_red = -g_s
        b_red[:, :6] += b6
        S = H_ss.permute(0, 2, 1, 3).reshape(W * D, W * D)
        b = b_red.reshape(W * D)
        if fix_first:
            S = S * gauge[:, None] * gauge[None, :] + torch.diag(1.0 - gauge)
            b = b * gauge
        delta_s = ba_mod.cholesky_solve_or_nan(S, b).reshape(W, D)
        rhs_l = -g_l - torch.einsum("wlij,wi->lj", H_pl6, delta_s[:, :6])
        delta_l = torch.einsum("lij,lj->li", H_ll_inv, rhs_l)
        delta_l = torch.where(lm_active[:, None], delta_l, zero)
        return (delta_s, delta_l, torch.isfinite(delta_s).all(),
                torch.isfinite(delta_l).all() & (inv_ok | ~lm_active).all())

    sys0, cost0 = assemble(visual(state, landmarks, mask0).blocks,
                           state_terms(state), lm_active0)

    st, lms, sys, cost = state, landmarks, sys0, cost0
    lam = torch.full((), cfg.lambda_init, dtype=dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = ~attempt
    status = torch.full((), ba_mod.STATUS_MAX_ITERATIONS, dtype=torch.int32,
                        device=dev)
    metrics = torch.zeros((cfg.max_iterations, ba_mod.N_METRIC_COLS),
                          dtype=dtype, device=dev)
    rows = torch.arange(cfg.max_iterations, device=dev)
    mask, lm_active = mask0, lm_active0
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)

    # Fixed trip count; an iteration after `done` leaves the carry as it was.
    for _ in range(cfg.max_iterations):
        live = ~done
        delta_s, delta_l, ok_s, ok_l = step(sys, lam, lm_active)
        ok_step, dl_sq, gl_sq, gl_dl, dl_pred = ba_mod._step_vote(
            reduce, ok_s, ok_l, delta_l, sys[4],
            ba_mod._clamped_diag(sys[1]))
        delta_s = torch.where(ok_step, delta_s, zero)
        delta_l = torch.where(ok_step, delta_l, zero)
        st_new = _retract_state(st, delta_s)
        lms_new = lms + delta_l
        asm = visual(st_new, lms_new, mask, cfg.chi2_gate)
        terms = state_terms(st_new)
        sys_new, new_cost = assemble(asm.blocks, terms, lm_active)
        accept = ok_step & torch.isfinite(new_cost) & (new_cost < cost)

        mask_n, lm_active_n = mask, lm_active
        if cfg.chi2_gate > 0.0:
            # Visual outlier gate after chi2_gate_iter accepted iterations,
            # with the under-constraint guard; IMU and prior untouched.
            do_gate = accept & (n_acc + 1 == max(1, cfg.chi2_gate_iter))
            n_b, n_a = reduce(asm.n_obs, asm.n_active)
            guard = ((n_b + n_imu >= cfg.min_residual_blocks)
                     & (2 * n_b + 15 * n_imu >= W * D - 6 + 3 * n_a))
            sys_g, cost_g = assemble(asm.gated, terms, asm.gate_active)
            take = do_gate & guard
            mask_n = torch.where(take, asm.gate_mask, mask)
            lm_active_n = torch.where(take, asm.gate_active, lm_active)
            sys_new = ba_mod._sel(take, sys_g, sys_new)
            new_cost = torch.where(take, cost_g, new_cost)
        n_acc_n = n_acc + accept.to(torch.int32)

        cost_conv = accept & (torch.abs(cost - new_cost)
                              <= cfg.cost_tol * torch.clamp(cost, min=1e-12))
        step_norm = torch.sqrt((delta_s ** 2).sum() + dl_sq)
        param_conv = accept & (step_norm <= cfg.param_tol)
        # Observer columns: gradient norm and gain ratio of the damped
        # normal equations' prediction, from the current system.
        g_s_u = sys[3]
        g_norm = torch.sqrt((g_s_u ** 2).sum() + gl_sq)
        d_s = block_diag(sys[0])
        pred = 0.5 * (lam * ((d_s * delta_s ** 2).sum() + dl_pred)
                      - ((g_s_u * delta_s).sum() + gl_dl))
        rho = ba_mod.step_quality(cost, new_cost, pred)
        row = ba_mod.metrics_row(new_cost, g_norm, lam, step_norm, rho,
                                 accept)
        metrics = torch.where(live & (rows == it)[:, None], row[None, :],
                              metrics)
        lam_n = torch.where(accept, torch.clamp(lam * 0.33, min=1e-12),
                            lam * 4.0)
        hard_fail = lam_n > cfg.lambda_max

        acc_live = accept & live
        st = ba_mod._sel(acc_live, st_new, st)
        lms = torch.where(acc_live, lms_new, lms)
        sys = ba_mod._sel(acc_live, sys_new, sys)
        cost = torch.where(acc_live, new_cost, cost)
        lam = torch.where(live, lam_n, lam)
        mask = torch.where(live, mask_n, mask)
        lm_active = torch.where(live, lm_active_n, lm_active)
        n_acc = torch.where(live, n_acc_n, n_acc)
        status = torch.where(live, ba_mod.lm_status(cost_conv, param_conv,
                                                    hard_fail), status)
        it = it + live.to(torch.int32)
        done = done | (live & (cost_conv | param_conv | hard_fail))

    status = torch.where(attempt, status,
                         torch.full_like(status, ba_mod.STATUS_SKIPPED))
    # Numerical-health gate: non-finite results roll back.
    finite = ba_mod.finite_vote(
        reduce, torch.isfinite(st.T_W_B).all() & torch.isfinite(st.vel).all()
        & torch.isfinite(st.bg).all() & torch.isfinite(st.ba).all(),
        lm_active, lms)
    success = attempt & (status != ba_mod.STATUS_FAILED) & finite
    res = VIOBAResult(state=ba_mod._sel(success, st, state),
                      landmarks=torch.where(success, lms, landmarks),
                      success=success, status=status, initial_cost=cost0,
                      final_cost=cost, iterations=it, metrics=metrics)
    return res, mask, sqrt_infos


def solve_vio_ba(state: VIOState, T_C_B, landmarks, obs, obs_mask, lm_valid,
                 preint: Preintegrated, preint_valid,
                 cfg: VIOBAConfig = VIOBAConfig(), fix_first: bool = True,
                 obs_weight=None, bias_alpha=None) -> VIOBAResult:
    """Joint visual-inertial window optimization.

    state: VIOState over W keyframes; T_C_B, landmarks, obs, obs_mask,
    lm_valid as in models.ba.solve_ba; preint: Preintegrated with leading
    dim (W-1), interval i joining keyframes i and i+1; preint_valid (W-1,)
    bool, missing intervals contribute nothing; obs_weight (W,L) optional
    observation sqrt-weights; bias_alpha (W-1,) optional desert factors
    (bias_desert_scales). On failure the inputs come back unchanged.
    """
    return _solve(state, T_C_B, landmarks, obs, obs_mask, lm_valid, preint,
                  preint_valid, cfg, fix_first, obs_weight, bias_alpha,
                  None)[0]


def build_eviction_prior(st_out: VIOState, lms_out, T_C_B, obs0, mask0,
                         preint0: Preintegrated, preint_valid0, sqrt_info0,
                         prior: MargPrior, cfg: VIOBAConfig,
                         obs_w0=None) -> MargPrior:
    """The next prior from the eviction system: the incoming prior, the
    IMU factor joining states 0-1 and, as the absolute-pose anchor
    (prior_visual_anchor), state 0's visual factors with the landmarks
    held fixed; state 0 marginalized, the result decayed by
    cfg.prior_decay and restricted to the configured subspace.

    obs0, mask0: state 0's observations (2,L,2) and final (chi^2-gated)
    mask (2,L); preint0 (unbatched), preint_valid0, sqrt_info0 (9,9): the
    interval 0-1. Returns the rolled MargPrior (validity set by
    marginalize_oldest; callers select on will_evict & success)."""
    W = st_out.T_W_B.shape[0]
    dtype, dev = st_out.T_W_B.dtype, st_out.T_W_B.device
    extra = _extra(st_out)
    H_ev, g_ev, _ = prior_terms(prior, st_out.T_W_B, extra)
    H_ev, g_ev = H_ev.clone(), g_ev.clone()
    r0, J0_i, J0_j = _imu_linearize_one(preint0, st_out, 0, cfg, sqrt_info0)
    w0 = preint_valid0.to(dtype)
    H_ev[:D, :D] += w0 * (J0_i.T @ J0_i)
    H_ev[D:2 * D, D:2 * D] += w0 * (J0_j.T @ J0_j)
    H_ev[:D, D:2 * D] += w0 * (J0_i.T @ J0_j)
    H_ev[D:2 * D, :D] += w0 * (J0_j.T @ J0_i)
    g_ev[:D] += w0 * (J0_i.T @ r0)
    g_ev[D:2 * D] += w0 * (J0_j.T @ r0)
    if cfg.prior_visual_anchor:
        lin0 = linearize_projection(
            T_C_B[:, None], lie.se3_inverse(st_out.T_W_B[0]),
            lms_out[None], obs0, mask0, cfg.huber_delta)       # (2, L)
        J_pose, r = lin0.J_pose, lin0.r
        if obs_w0 is not None:
            # The window solve's birth-score weighting.
            sw = obs_w0[None, :, None]
            r, J_pose = r * sw, J_pose * sw[..., None]
        Jv, rv = J_pose.reshape(-1, 6), r.reshape(-1)
        H_ev[:6, :6] += Jv.T @ Jv
        g_ev[:6] += Jv.T @ rv
    new_prior = marginalize_oldest(H_ev, g_ev, st_out.T_W_B, extra, prior, D)
    H_new = new_prior.H * cfg.prior_decay
    g_new = new_prior.g * cfg.prior_decay
    keep = None
    ones = torch.ones(D, dtype=dtype, device=dev)
    if cfg.prior_velocity_bias_only:
        keep = torch.cat([ones[:6] * 0.0, ones[6:]]).repeat(W)
    elif cfg.prior_drop_bias:
        keep = torch.cat([ones[:9], ones[9:] * 0.0]).repeat(W)
    if keep is not None:
        H_new = H_new * keep[:, None] * keep[None, :]
        g_new = g_new * keep
    return new_prior._replace(H=H_new, g=g_new)


def solve_vio_ba_marginalized(state: VIOState, T_C_B, landmarks, obs,
                              obs_mask, lm_valid, preint: Preintegrated,
                              preint_valid, prior: MargPrior, will_evict,
                              cfg: VIOBAConfig = VIOBAConfig(),
                              obs_weight=None, bias_alpha=None):
    """solve_vio_ba with a 15-dim-state prior (block size 15: pose in the
    T_B_W split-retraction tangent, additive velocity and biases), and the
    next prior.

    The first pose is always gauge-fixed (unlike the VO marginalized solve,
    whose prior folds the whole visual system): this prior comes from the
    eviction system, which carries little absolute pose information.
    will_evict () bool: where set and the solve succeeds, the returned
    prior is build_eviction_prior's at the result; otherwise the input
    prior comes back. Returns (VIOBAResult, new MargPrior)."""
    res, mask_f, sqrt_infos = _solve(
        state, T_C_B, landmarks, obs, obs_mask, lm_valid, preint,
        preint_valid, cfg, True, obs_weight, bias_alpha, prior)
    return res, next_prior(res, T_C_B, obs[0], mask_f[0], preint,
                           preint_valid, sqrt_infos[0], prior, will_evict,
                           cfg, None if obs_weight is None else obs_weight[0])


def next_prior(res: VIOBAResult, T_C_B, obs0, mask0, preint: Preintegrated,
               preint_valid, sqrt_info0, prior: MargPrior, will_evict,
               cfg: VIOBAConfig, obs_w0=None) -> MargPrior:
    """solve_vio_ba_marginalized's returned prior: build_eviction_prior's
    at the result where will_evict and the solve succeeded, else the
    input prior. obs0, mask0, obs_w0: state 0's observations, final mask
    and weights over all landmarks (res.landmarks')."""
    new_prior = build_eviction_prior(
        res.state, res.landmarks, T_C_B, obs0, mask0,
        Preintegrated(*(x[0] for x in preint)), preint_valid[0], sqrt_info0,
        prior, cfg, obs_w0=obs_w0)
    do_new = will_evict & res.success
    return MargPrior(*(torch.where(do_new, n, o)
                       for n, o in zip(new_prior, prior)))
