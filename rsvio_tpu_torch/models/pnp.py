"""PnP motion tracking: Levenberg-Marquardt over one SE(3) pose against
fixed map points.

Port of ``solve_pnp`` from rsvio_tpu/models/pnp.py, with the chi^2 gate and
the motion prior. ``ransac_pnp_gate`` is not ported yet (ROADMAP A13).

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
    return torch.where(info == 0, x, torch.full_like(x, torch.nan))


def solve_pnp(T_W_B_init, T_C_B, landmarks, obs, mask,
              cfg: PnPConfig = PnPConfig(), T_W_B_prior=None) -> PnPResult:
    """Levenberg-Marquardt pose-only solve.

    T_W_B_init (4,4), T_C_B (2,4,4), landmarks (L,3), obs (2,L,2)
    normalized observations, mask (2,L) bool. T_W_B_prior anchors the
    optional motion prior (defaults to the init). On failure T_W_B is the
    init.
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
        J = lin.J_pose.reshape(-1, 6)
        r = lin.r.reshape(-1)
        H = J.T @ J
        g = J.T @ r
        cost = lin.cost.sum()
        if cfg.motion_prior_weight > 0.0:
            w = cfg.motion_prior_weight
            dt_p = T_B_W[:3, 3] - T_B_W_prior[:3, 3]
            dw_p = lie.so3_log(T_B_W_prior[:3, :3].T @ T_B_W[:3, :3])
            d = torch.cat([dt_p, dw_p])
            H = H + (w * w) * eye6
            g = g + (w * w) * d
            cost = cost + 0.5 * (w * w) * (d * d).sum()
        return H, g, cost, (lin.r ** 2).sum(-1)

    H, g, cost, _ = linearize(T_B_W0, mask)
    T = T_B_W0
    lam = torch.tensor(cfg.lambda_init, dtype=dtype, device=dev)
    it = torch.tensor(0, dtype=torch.int32, device=dev)
    done = ~enough
    status = torch.tensor(STATUS_MAX_ITERATIONS, dtype=torch.int32,
                          device=dev)
    metrics = torch.zeros((cfg.max_iterations, ba_mod.N_METRIC_COLS),
                          dtype=dtype, device=dev)
    m = mask
    n_acc = torch.tensor(0, dtype=torch.int32, device=dev)
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
