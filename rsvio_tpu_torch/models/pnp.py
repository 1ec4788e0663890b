"""PnP motion tracking: Levenberg-Marquardt over one SE(3) pose against
fixed map points.

Port of rsvio_tpu/models/pnp.py: ``solve_pnp`` with the chi^2 gate, the
motion prior (scaled at run time by ``prior_scale``) and per-slot
observation weights, and the RANSAC consensus pre-gate ``ransac_pnp_gate``.

As in ``models.ba``: the JAX ``lax.while_loop`` becomes a fixed-trip loop
that freezes its carry once ``done`` is set, and the 6x6 damped solve uses
``torch.linalg.solve_ex`` so a singular system yields non-finite values (a
rejected step, as in JAX) instead of an exception.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie
from ..ops.projection import linearize_projection
from . import ba as ba_mod

STATUS_MAX_ITERATIONS = 0
STATUS_COST_TOL = 1
STATUS_PARAM_TOL = 2
STATUS_FAILED = 3
STATUS_TRUST_REGION = 5


class PnPConfig(NamedTuple):
    """Same fields and defaults as the JAX PnPConfig."""
    max_iterations: int = 10
    huber_delta: float = 2.0
    cost_tol: float = 1e-6
    param_tol: float = 1e-9
    lambda_init: float = 1e-4
    lambda_max: float = 1e8
    min_observations: int = 6
    chi2_gate: float = 0.0
    chi2_gate_iter: int = 1
    motion_prior_weight: float = 0.0
    ransac_hypotheses: int = 0
    ransac_sample: int = 4
    ransac_gn_iters: int = 4
    ransac_threshold: float = 8e-3
    ransac_min_inliers: int = 12
    ransac_age_cap: int = 10
    ransac_age_floor: float = 0.1


class PnPResult(NamedTuple):
    T_W_B: torch.Tensor       # (4,4) optimized world-from-body pose
    success: torch.Tensor     # () bool
    status: torch.Tensor      # () int32
    final_cost: torch.Tensor  # ()
    iterations: torch.Tensor  # () int32
    metrics: torch.Tensor = None  # (max_iterations, N_METRIC_COLS)


def solve_or_nan(A, b):
    """Solve A x = b; NaNs for a singular A instead of an exception."""
    x, info = torch.linalg.solve_ex(A, b)
    ok = (info == 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(ok, x, torch.full_like(x, torch.nan))


def solve_pnp(T_W_B_init, T_C_B, landmarks, obs, mask,
              cfg: PnPConfig = PnPConfig(), T_W_B_prior=None,
              obs_weight=None, prior_scale=None) -> PnPResult:
    """Levenberg-Marquardt pose-only solve.

    T_W_B_init (4,4), T_C_B (2,4,4), landmarks (L,3), obs (2,L,2)
    normalized observations, mask (2,L) bool. T_W_B_prior anchors the
    optional motion prior (defaults to the init); prior_scale, a 0-d
    tensor, multiplies its weight. obs_weight (L,) scales each slot's
    whitened residuals and Jacobians (its cost by the square). On failure
    T_W_B is the init.
    """
    dtype, dev = T_W_B_init.dtype, T_W_B_init.device
    T_B_W0 = lie.se3_inverse(T_W_B_init)
    T_B_W_prior = (T_B_W0 if T_W_B_prior is None
                   else lie.se3_inverse(T_W_B_prior))
    enough = mask.sum() >= cfg.min_observations
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def linearize(T_B_W, m):
        lin = linearize_projection(T_C_B[:, None], T_B_W, landmarks[None],
                                   obs, m, cfg.huber_delta)
        if obs_weight is not None:
            sw = obs_weight[None, :, None]
            lin = lin._replace(r=lin.r * sw, J_pose=lin.J_pose * sw[..., None],
                               cost=lin.cost * obs_weight[None, :] ** 2)
        J = lin.J_pose.reshape(-1, 6)
        r = lin.r.reshape(-1)
        H = J.T @ J
        g = J.T @ r
        cost = lin.cost.sum()
        if cfg.motion_prior_weight > 0.0:
            w = cfg.motion_prior_weight
            if prior_scale is not None:
                w = w * prior_scale
            dt_p = T_B_W[:3, 3] - T_B_W_prior[:3, 3]
            dw_p = lie.so3_log(T_B_W_prior[:3, :3].T @ T_B_W[:3, :3])
            d = torch.cat([dt_p, dw_p])
            H = H + (w * w) * eye6
            g = g + (w * w) * d
            cost = cost + 0.5 * (w * w) * (d * d).sum()
        return H, g, cost, (lin.r ** 2).sum(-1)

    H, g, cost, _ = linearize(T_B_W0, mask)
    T = T_B_W0
    lam = torch.full((), cfg.lambda_init, dtype=dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = ~enough
    status = torch.full((), STATUS_MAX_ITERATIONS, dtype=torch.int32,
                        device=dev)
    metrics = torch.zeros((cfg.max_iterations, ba_mod.N_METRIC_COLS),
                          dtype=dtype, device=dev)
    m = mask
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    rows = torch.arange(cfg.max_iterations, device=dev)

    # Fixed trip count; an iteration after `done` leaves the carry as it was.
    for _ in range(cfg.max_iterations):
        live = ~done
        diag = torch.clamp(torch.diagonal(H), min=1e-8)
        delta = -solve_or_nan(H + lam * torch.diag(diag), g)
        ok_step = torch.isfinite(delta).all()
        delta = torch.where(ok_step, delta, zero)
        T_new = lie.se3_retract_split(T, delta)
        H_new, g_new, new_cost, r_sq_new = linearize(T_new, m)
        accept = ok_step & torch.isfinite(new_cost) & (new_cost < cost)

        m_n = m
        if cfg.chi2_gate > 0.0:
            m_g = m & (r_sq_new <= cfg.chi2_gate ** 2)
            m_g = torch.where(m_g.sum() >= cfg.min_observations, m_g, m)
            H_g, g_g, cost_g, _ = linearize(T_new, m_g)
            do_gate = accept & (n_acc + 1 == max(1, cfg.chi2_gate_iter))
            m_n = torch.where(do_gate, m_g, m)
            H_new = torch.where(do_gate, H_g, H_new)
            g_new = torch.where(do_gate, g_g, g_new)
            new_cost = torch.where(do_gate, cost_g, new_cost)
        n_acc_n = n_acc + accept.to(torch.int32)

        cost_conv = accept & (torch.abs(cost - new_cost)
                              <= cfg.cost_tol * torch.clamp(cost, min=1e-12))
        step_norm = torch.linalg.vector_norm(delta)
        param_conv = accept & (step_norm <= cfg.param_tol)
        pred = 0.5 * (lam * (diag * delta ** 2).sum() - (g * delta).sum())
        rho = ba_mod.step_quality(cost, new_cost, pred)
        row = ba_mod.metrics_row(new_cost, torch.linalg.vector_norm(g), lam,
                                 step_norm, rho, accept)
        metrics = torch.where(live & (rows == it)[:, None], row[None, :],
                              metrics)
        lam_n = torch.where(accept, torch.clamp(lam * 0.33, min=1e-12),
                            lam * 3.0)
        hard_fail = lam_n > cfg.lambda_max

        acc_live = accept & live
        T = torch.where(acc_live, T_new, T)
        H = torch.where(acc_live, H_new, H)
        g = torch.where(acc_live, g_new, g)
        cost = torch.where(acc_live, new_cost, cost)
        lam = torch.where(live, lam_n, lam)
        m = torch.where(live, m_n, m)
        n_acc = torch.where(live, n_acc_n, n_acc)
        status = torch.where(
            live, ba_mod.lm_status(cost_conv, param_conv, hard_fail), status)
        it = it + live.to(torch.int32)
        done = done | (live & (cost_conv | param_conv | hard_fail))

    success = enough & (status != STATUS_FAILED) & torch.isfinite(T).all()
    T_W_B = torch.where(success, lie.se3_inverse(T), T_W_B_init)
    return PnPResult(T_W_B=T_W_B, success=success, status=status,
                     final_cost=cost, iterations=it, metrics=metrics)


def integral_vote_floor(cfg: PnPConfig):
    """round(ransac_age_floor * ransac_age_cap) when that product is an
    integer (the defaults: 1), else None."""
    lo = cfg.ransac_age_floor * cfg.ransac_age_cap
    return int(round(lo)) if abs(lo - round(lo)) <= 1e-9 else None


def ransac_votes(inliers, age, cfg: PnPConfig, vote_w):
    """Each hypothesis' age-weighted vote, (K,), from its inliers (K,2,L).

    Where the weights clip(age / cap, floor, 1) are cap-ths of integers
    (floor * cap integral), the vote is the exact integer sum of
    clip(age, floor * cap, cap) = cap * weight: it ranks the hypotheses as
    the weighted vote does, and an exact tie stays a tie, so argmax gives
    it to the lowest index on every device. (A floating-point sum breaks
    such a tie by its rounding order, which differs between XLA's CPU
    reduction, PyTorch's and CUDA's; on a 0.1 grid ties are common.)
    Without ages every weight is 1 and the count is exact too. Otherwise
    the vote is the floating-point sum of vote_w, as the JAX package's."""
    lo = integral_vote_floor(cfg)
    if age is None or cfg.ransac_age_cap <= 0:
        return inliers.to(torch.int64).sum(dim=(1, 2))
    if lo is not None:
        w = torch.clamp(age.to(torch.int64), lo, cfg.ransac_age_cap)
        return (inliers.to(torch.int64) * w[None, None, :]).sum(dim=(1, 2))
    return (inliers.to(vote_w.dtype) * vote_w[None, None, :]).sum(dim=(1, 2))


def ransac_pnp_gate(T_W_B_init, T_C_B, landmarks, obs, mask, gumbel,
                    cfg: PnPConfig, age=None):
    """Batched RANSAC consensus gate for pose-only tracking.

    K = cfg.ransac_hypotheses minimal samples of S = cfg.ransac_sample
    distinct valid observations are drawn at once (Gumbel-top-S over the
    valid mask, age-weighted), K damped Gauss-Newton pose solves run as one
    batched program, every observation is verified against every
    hypothesis (K x 2L), and the age-weighted vote picks the winner.

    T_W_B_init (4,4) seeds every hypothesis; T_C_B (2,4,4); landmarks
    (L,3); obs (2,L,2); mask (2,L). gumbel (K, 2L) are the Gumbel(0, 1)
    draws (the caller's; the JAX package draws them from a threefry key,
    which torch cannot reproduce, so tests pass the same draws to both).
    age (L,) int track ages weight votes and draws by clip(age / age_cap,
    age_floor, 1); None = unweighted.

    Returns (inlier_mask (2,L), ok (), best_count () int32): when ok the
    winning consensus set (a subset of mask); below the consensus floor the
    gate disengages and mask comes back unchanged.
    """
    inliers, vote_w = ransac_hypotheses(T_W_B_init, T_C_B, landmarks, obs,
                                        mask, gumbel, cfg, age)
    # Winner by age-weighted vote; the consensus floor is an unweighted
    # count. argmax takes the first maximum, as jnp.argmax.
    best = torch.argmax(ransac_votes(inliers, age, cfg, vote_w))
    # index_select: indexing with a 0-d tensor reads it on the host.
    best_inl = inliers.index_select(0, best.reshape(1))[0]
    best_count = best_inl.to(torch.int32).sum(dtype=torch.int32)
    n_valid = mask.sum()
    ok = ((best_count >= cfg.ransac_min_inliers)
          & (n_valid >= cfg.ransac_min_inliers))
    return torch.where(ok, best_inl, mask), ok, best_count


def ransac_hypotheses(T_W_B_init, T_C_B, landmarks, obs, mask, gumbel,
                      cfg: PnPConfig, age=None):
    """The gate's K hypotheses (ransac_pnp_gate's arguments): every
    hypothesis' inlier set (K,2,L) and the per-landmark vote weights
    vote_w (L,)."""
    S = cfg.ransac_sample
    L = landmarks.shape[0]
    dtype, dev = T_W_B_init.dtype, T_W_B_init.device
    T_B_W0 = lie.se3_inverse(T_W_B_init)
    flat_mask = mask.reshape(-1)                            # (2L,)

    if age is not None and cfg.ransac_age_cap > 0:
        vote_w = torch.clamp(age.to(dtype) / cfg.ransac_age_cap,
                             cfg.ransac_age_floor, 1.0)      # (L,)
    else:
        vote_w = torch.ones(L, dtype=dtype, device=dev)
    flat_w = vote_w.repeat(2)                               # (2L,)

    # Gumbel-top-S: S distinct valid indices per hypothesis, index i drawn
    # with probability proportional to its weight. A stable descending sort
    # keeps the lower index first on ties (-inf rows when fewer than S are
    # valid), as lax.top_k does; torch.topk does not promise that order.
    g = gumbel.to(dtype) + torch.log(flat_w)
    scores = torch.where(flat_mask[None, :], g,
                         torch.full_like(g, -torch.inf))
    idx = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :S]
    cam_i, lm_i = idx // L, idx % L                         # (K,S)

    Tcb = T_C_B[cam_i]                                      # (K,S,4,4)
    p = landmarks[lm_i]                                     # (K,S,3)
    o = obs[cam_i, lm_i]                                    # (K,S,2)
    m = mask[cam_i, lm_i]                                   # (K,S)
    K = idx.shape[0]
    eye6 = 1e-4 * torch.eye(6, dtype=dtype, device=dev)
    T = T_B_W0.expand(K, 4, 4)
    for _ in range(cfg.ransac_gn_iters):
        lin = linearize_projection(Tcb, T[:, None], p, o, m, cfg.huber_delta)
        J = lin.J_pose.reshape(K, -1, 6)
        r = lin.r.reshape(K, -1)
        H = J.transpose(1, 2) @ J + eye6
        delta = -solve_or_nan(H, (J.transpose(1, 2) @ r[..., None])[..., 0])
        ok_step = torch.isfinite(delta).all(dim=1, keepdim=True)
        T = lie.se3_retract_split(T, torch.where(ok_step, delta,
                                                 torch.zeros_like(delta)))

    # Verify: squared reprojection error of every observation under every
    # hypothesis, (K, 2, L); behind the camera counts as infinite.
    R_bw, t_bw = T[:, None, None, :3, :3], T[:, None, None, :3, 3]
    R_cb, t_cb = T_C_B[None, :, None, :3, :3], T_C_B[None, :, None, :3, 3]
    p_B = (R_bw @ landmarks[None, None, :, :, None])[..., 0] + t_bw
    p_C = (R_cb @ p_B[..., None])[..., 0] + t_cb            # (K,2,L,3)
    in_front = p_C[..., 2] > 1e-6
    z = torch.where(in_front, p_C[..., 2], torch.ones_like(p_C[..., 2]))
    e = ((p_C[..., :2] / z[..., None] - obs[None]) ** 2).sum(-1)
    r2 = torch.where(in_front, e, torch.full_like(e, torch.inf))
    finite = torch.isfinite(T).flatten(1).all(dim=1)        # (K,)
    inliers = (mask[None] & (r2 < cfg.ransac_threshold ** 2)
               & finite[:, None, None])                     # (K,2,L)
    return inliers, vote_w
