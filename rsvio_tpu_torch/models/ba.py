"""Sliding-window bundle adjustment: Levenberg-Marquardt with a Schur
complement over landmark blocks.

Port of ``solve_ba`` and its pieces from rsvio_tpu/models/ba.py: the dense
masked observation tensor obs (W, 2, L, 2) + mask (W, 2, L), the
linearization and normal-equation blocks of each system with the
per-observation weights in one ``ops.cuda.ba_kernel.ba_assemble`` call
(the K3 kernel on the card, the plain composition on the CPU), closed-form
3x3 landmark inverses, a Cholesky solve of the reduced camera system with
pose 0 gauge-fixed, LM accept/reject with rollback, and
``solve_ba_marginalized``: the same solve with a marginalization prior over
the poses, producing the next prior.

Both solvers take a ``reduce`` hook: every sum over landmarks the LM loop
needs whole (the pose blocks and cost, the Schur system, the step's
validity vote and metric pieces, the chi^2 regate's counts, the
observability counts and the final finiteness vote) goes through one call
``reduce(*tensors) -> tensors``. It is the identity on one device;
parallel.dist_ba passes the mesh's packed all-reduce, so the same loop
solves one landmark shard per rank (JAX's copies of the loop in
rsvio_tpu/parallel/dist_ba.py pack their ``psum``s at the same points).

Two deliberate differences of form, same results:
  * The JAX ``lax.while_loop`` with early exit becomes a fixed-trip loop of
    ``max_iterations`` iterations that freezes the whole carry once ``done``
    is set: no host sync inside the solve.
  * ``jax.scipy.linalg.cho_factor`` yields NaNs for a matrix that is not
    positive definite, which the step's finiteness check turns into a
    rejected step. ``torch.linalg.cholesky`` would raise instead, so this
    uses ``cholesky_ex`` and maps ``info != 0`` to NaN.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie
from ..ops.cuda.ba_kernel import ba_assemble, stereo_observability_mask
from .marginalization import MargPrior, marginalize_oldest, prior_terms

STATUS_MAX_ITERATIONS = 0
STATUS_COST_TOL = 1
STATUS_PARAM_TOL = 2
STATUS_FAILED = 3
STATUS_SKIPPED = 4
STATUS_TRUST_REGION = 5

N_METRIC_COLS = 6
METRIC_NAMES = ("cost", "gradient_norm", "lambda", "step_norm",
                "step_quality", "accepted")


class BAConfig(NamedTuple):
    """Same fields and defaults as the JAX BAConfig."""
    max_iterations: int = 20
    huber_delta: float = 2.0
    cost_tol: float = 1e-6
    param_tol: float = 1e-9
    lambda_init: float = 1e-4
    lambda_max: float = 1e8
    min_residual_blocks: int = 6
    translation_only: bool = False
    chi2_gate: float = 0.0
    chi2_gate_iter: int = 1
    min_lm_span: int = 1


class BAResult(NamedTuple):
    T_W_B: torch.Tensor      # (W,4,4) optimized poses
    landmarks: torch.Tensor  # (L,3)
    success: torch.Tensor    # () bool — on failure the inputs come back
    status: torch.Tensor     # () int32
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor  # () int32
    metrics: torch.Tensor = None  # (max_iterations, N_METRIC_COLS)


def metrics_row(new_cost, g_norm, lam, step_norm, rho, accept):
    return torch.stack([new_cost, g_norm, lam, step_norm, rho,
                        accept.to(new_cost.dtype)])


def step_quality(cost, new_cost, pred_red):
    """Gain ratio rho = actual / predicted cost reduction."""
    return (cost - new_cost) / torch.clamp(pred_red, min=1e-20)


def lm_status(cost_conv, param_conv, lam_overflow):
    """Shared LM status: cost tol > param tol > trust region > max iters."""
    def c(v):
        return torch.full_like(cost_conv, v, dtype=torch.int32)
    return torch.where(cost_conv, c(STATUS_COST_TOL),
                       torch.where(param_conv, c(STATUS_PARAM_TOL),
                                   torch.where(lam_overflow,
                                               c(STATUS_TRUST_REGION),
                                               c(STATUS_MAX_ITERATIONS))))


def lm_span_gate(lm_active, obs_mask, min_lm_span: int):
    """Keep a landmark only once its observations span >= min_lm_span
    window rows."""
    if min_lm_span > 1:
        span = obs_mask.any(dim=1).sum(dim=0)
        lm_active = lm_active & (span >= min_lm_span)
    return lm_active


def _inv3x3(M):
    """Closed-form batched 3x3 inverse by adjugate. Returns (inv, ok)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det_safe = torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
    ], dim=-2)
    return adj / det_safe[..., None, None], torch.abs(det) > 1e-12


def local_reduce(*tensors):
    """The identity reduction of a single-device solve."""
    return tensors


def _clamped_diag(H):
    return torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-8)


def cholesky_solve_or_nan(S, b):
    """Solve S x = b (b a vector or a matrix) by Cholesky; NaNs (not an
    exception, no host sync) when S is not positive definite, as the JAX
    reference's cho_factor gives."""
    Lc, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(b[:, None] if b.dim() == 1 else b, Lc)
    x = x[:, 0] if b.dim() == 1 else x
    return torch.where(info == 0, x, torch.full_like(x, torch.nan))


def _schur_step(H_pp, H_ll, H_pl, g_p, g_l, lam, lm_active, reduce):
    """schur_solve's work with the Schur system (S, b) reduced over the
    landmark shards. Returns (delta_pose, delta_lm, delta_pose finite,
    this shard's landmark step valid): the caller votes on the last."""
    W = H_pp.shape[0]
    dtype, dev = H_pp.dtype, H_pp.device
    dp = _clamped_diag(H_pp)                          # (W,6)
    H_pp_d = H_pp + lam * torch.diag_embed(dp)
    dl = _clamped_diag(H_ll)                          # (L,3)
    H_ll_d = H_ll + lam * torch.diag_embed(dl)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    H_ll_d = torch.where(lm_active[:, None, None], H_ll_d, eye3)
    g_l = torch.where(lm_active[:, None], g_l, torch.zeros_like(g_l))
    H_pl = torch.where(lm_active[None, :, None, None], H_pl,
                       torch.zeros_like(H_pl))

    H_ll_inv, inv_ok = _inv3x3(H_ll_d)
    A = torch.einsum("wlij,ljk->wlik", H_pl, H_ll_inv)
    S_blocks, b_l = reduce(-torch.einsum("wlik,vljk->wvij", A, H_pl),
                           torch.einsum("wlik,lk->wi", A, g_l))
    ar = torch.arange(W, device=dev)
    S_blocks[ar, ar] += H_pp_d
    b_red = -(g_p - b_l)                                     # (W,6)
    S = S_blocks.permute(0, 2, 1, 3).reshape(W * 6, W * 6)
    b = b_red.reshape(W * 6)
    # Gauge fix: identity rows/cols for pose 0, zero rhs -> delta0 = 0.
    mask = torch.cat([torch.zeros(6, dtype=dtype, device=dev),
                      torch.ones((W - 1) * 6, dtype=dtype, device=dev)])
    S = S * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    b = b * mask
    delta_p = cholesky_solve_or_nan(S, b).reshape(W, 6)
    rhs_l = -g_l - torch.einsum("wlij,wi->lj", H_pl, delta_p)
    delta_l = torch.einsum("lij,lj->li", H_ll_inv, rhs_l)
    delta_l = torch.where(lm_active[:, None], delta_l,
                          torch.zeros_like(delta_l))
    return (delta_p, delta_l, torch.isfinite(delta_p).all(),
            torch.isfinite(delta_l).all() & (inv_ok | ~lm_active).all())


def schur_solve(H_pp, H_ll, H_pl, g_p, g_l, lam, lm_active):
    """Damped Schur-complement solve of the BA normal equations, pose 0
    gauge-fixed. Inactive landmarks get identity blocks and a zero update.
    Returns (delta_pose (W,6), delta_lm (L,3), ok)."""
    delta_p, delta_l, ok_p, ok_l = _schur_step(
        H_pp, H_ll, H_pl, g_p, g_l, lam, lm_active, local_reduce)
    return delta_p, delta_l, ok_p & ok_l


def _step_vote(reduce, ok_p, ok_l, delta_l, g_l_m, d_l):
    """One reduction for the step: the validity vote over the shards and
    the landmark pieces of the step norm and the observer metrics,
    (ok_step, |dl|^2, |g_l|^2, g_l.dl, sum d_l dl^2), the step pieces
    zero where the step is rejected."""
    n_bad, dl_sq, gl_sq, gl_dl, dl_pred = reduce(
        (~ok_l).to(torch.int32), (delta_l ** 2).sum(), (g_l_m ** 2).sum(),
        (g_l_m * delta_l).sum(), (d_l * delta_l ** 2).sum())
    ok_step = ok_p & (n_bad == 0)
    zero = torch.zeros_like(dl_sq)
    return (ok_step, torch.where(ok_step, dl_sq, zero), gl_sq,
            torch.where(ok_step, gl_dl, zero),
            torch.where(ok_step, dl_pred, zero))


def finite_vote(reduce, replicated_ok, lm_active, lms):
    """The numerical-health gate: the replicated state finite and, on
    every shard, the active landmarks."""
    bad, = reduce((~torch.isfinite(torch.where(
        lm_active[:, None], lms, torch.zeros_like(lms))).all())
        .to(torch.int32))
    return replicated_ok & (bad == 0)


def _sel(c, new, old):
    """where(c, new, old) for a 0-d bool c over tensors, tuples and
    NamedTuples."""
    if isinstance(new, tuple):
        out = (_sel(c, n, o) for n, o in zip(new, old))
        return type(new)(*out) if hasattr(new, "_fields") else tuple(out)
    return torch.where(c, new, old)


def solve_ba(T_W_B, T_C_B, landmarks, obs, obs_mask, lm_valid,
             cfg: BAConfig = BAConfig(), obs_weight=None,
             reduce=local_reduce) -> BAResult:
    """Sliding-window bundle adjustment.

    T_W_B (W,4,4) keyframe poses, T_C_B (2,4,4) stereo extrinsics,
    landmarks (L,3), obs (W,2,L,2) normalized observations, obs_mask
    (W,2,L), lm_valid (L,), optional obs_weight (W,L) per-observation
    sqrt-weights. On failure the inputs come back unchanged. `reduce`: the
    landmark-shard reduction (module docstring); with a mesh's, the
    landmark arguments are this rank's shard and so are the returned
    landmarks.
    """
    dtype, dev = T_W_B.dtype, T_W_B.device
    W = T_W_B.shape[0]
    lm_active0 = lm_span_gate(stereo_observability_mask(obs_mask, lm_valid),
                              obs_mask, cfg.min_lm_span)
    mask0 = obs_mask & lm_active0[None, None, :]
    n_blocks, n_act0 = reduce(mask0.sum(), lm_active0.sum())
    n_vars = (W - 1) * 6 + 3 * n_act0
    attempt = (n_blocks >= cfg.min_residual_blocks) & (n_blocks * 2 >= n_vars)

    T_B_W0 = lie.se3_inverse(T_W_B)

    def assemble(T_B_W, lms, mask, chi2_gate=0.0):
        return ba_assemble(T_B_W, T_C_B, lms, obs, mask, obs_weight,
                           lm_valid, cfg.huber_delta, chi2_gate)

    def system(b):
        """The blocks with the pose blocks and cost reduced."""
        H_pp, g_p, cost = reduce(b.H_pp, b.g_p, b.cost)
        return (H_pp, b.H_ll, b.H_pl, g_p, b.g_l), cost

    sys0, cost0 = system(assemble(T_B_W0, landmarks, mask0).blocks)

    T_B_W, lms, sys, cost = T_B_W0, landmarks, sys0, cost0
    lam = torch.full((), cfg.lambda_init, dtype=dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = ~attempt
    status = torch.full((), STATUS_MAX_ITERATIONS, dtype=torch.int32,
                        device=dev)
    metrics = torch.zeros((cfg.max_iterations, N_METRIC_COLS), dtype=dtype,
                          device=dev)
    mask, lm_active = mask0, lm_active0
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    # Fixed trip count; an iteration after `done` leaves the carry as it was.
    # Every rank makes the same reductions in every iteration.
    for _ in range(cfg.max_iterations):
        live = ~done
        H_pp, H_ll, H_pl, g_p, g_l = sys
        delta_p, delta_l, ok_p, ok_l = _schur_step(
            H_pp, H_ll, H_pl, g_p, g_l, lam, lm_active, reduce)
        ok_step, dl_sq, gl_sq, gl_dl, dl_pred = _step_vote(
            reduce, ok_p, ok_l, delta_l,
            torch.where(lm_active[:, None], g_l, zero), _clamped_diag(H_ll))
        if cfg.translation_only:
            delta_p = torch.cat([delta_p[:, :3],
                                 torch.zeros_like(delta_p[:, 3:])], dim=1)
        delta_p = torch.where(ok_step, delta_p, zero)
        delta_l = torch.where(ok_step, delta_l, zero)
        T_new = lie.se3_retract_split(T_B_W, delta_p)
        lms_new = lms + delta_l
        asm = assemble(T_new, lms_new, mask, cfg.chi2_gate)
        sys_new, new_cost = system(asm.blocks)
        accept = ok_step & torch.isfinite(new_cost) & (new_cost < cost)

        mask_n, lm_active_n = mask, lm_active
        if cfg.chi2_gate > 0.0:
            # Outlier gate after chi2_gate_iter accepted iterations, with the
            # same under-constraint guard as the reference (both branches
            # assembled in the same pass, one selected; where the guard
            # fails the gated branch is the ungated system). The observer's
            # landmark gradient pieces follow the gated landmark set where
            # the gate takes.
            do_gate = accept & (n_acc + 1 == max(1, cfg.chi2_gate_iter))
            m, act = asm.gate_mask, asm.gate_active
            g_l_g = torch.where(act[:, None], g_l, zero)
            n_b, n_a, gl_sq_g, gl_dl_g = reduce(
                asm.n_obs, asm.n_active, (g_l_g ** 2).sum(),
                (g_l_g * delta_l).sum())
            guard = ((n_b >= cfg.min_residual_blocks)
                     & (2 * n_b >= (W - 1) * 6 + 3 * n_a))
            sys_g, cost_g = system(asm.gated)
            take = do_gate & guard
            mask_n = torch.where(take, m, mask)
            lm_active_n = torch.where(take, act, lm_active)
            sys_new = _sel(take, sys_g, sys_new)
            new_cost = torch.where(take, cost_g, new_cost)
            gl_sq = torch.where(take, gl_sq_g, gl_sq)
            gl_dl = torch.where(take, gl_dl_g, gl_dl)
        n_acc_n = n_acc + accept.to(torch.int32)

        cost_conv = accept & (torch.abs(cost - new_cost)
                              <= cfg.cost_tol * torch.clamp(cost, min=1e-12))
        step_norm = torch.sqrt((delta_p ** 2).sum() + dl_sq)
        param_conv = accept & (step_norm <= cfg.param_tol)
        g_norm = torch.sqrt((g_p ** 2).sum() + gl_sq)
        d_p = _clamped_diag(H_pp)
        pred = 0.5 * (lam * ((d_p * delta_p ** 2).sum() + dl_pred)
                      - ((g_p * delta_p).sum() + gl_dl))
        rho = step_quality(cost, new_cost, pred)
        row = metrics_row(new_cost, g_norm, lam, step_norm, rho, accept)
        metrics = torch.where(
            live & (torch.arange(cfg.max_iterations, device=dev) == it)[:, None],
            row[None, :], metrics)
        lam_n = torch.where(accept, torch.clamp(lam * 0.33, min=1e-12),
                            lam * 4.0)
        hard_fail = lam_n > cfg.lambda_max

        acc_live = accept & live
        T_B_W = torch.where(acc_live, T_new, T_B_W)
        lms = torch.where(acc_live, lms_new, lms)
        sys = _sel(acc_live, sys_new, sys)
        cost = torch.where(acc_live, new_cost, cost)
        lam = torch.where(live, lam_n, lam)
        mask = torch.where(live, mask_n, mask)
        lm_active = torch.where(live, lm_active_n, lm_active)
        n_acc = torch.where(live, n_acc_n, n_acc)
        status = torch.where(live, lm_status(cost_conv, param_conv, hard_fail),
                             status)
        it = it + live.to(torch.int32)
        done = done | (live & (cost_conv | param_conv | hard_fail))

    status = torch.where(attempt, status, torch.full_like(status,
                                                          STATUS_SKIPPED))
    finite = finite_vote(reduce, torch.isfinite(T_B_W).all(), lm_active, lms)
    success = attempt & (status != STATUS_FAILED) & finite
    T_W_B_out = torch.where(success, lie.se3_inverse(T_B_W), T_W_B)
    lms_out = torch.where(success, lms, landmarks)
    return BAResult(T_W_B=T_W_B_out, landmarks=lms_out, success=success,
                    status=status, initial_cost=cost0, final_cost=cost,
                    iterations=it, metrics=metrics)


def solve_ba_marginalized(T_W_B, T_C_B, landmarks, obs, obs_mask, lm_valid,
                          prior: MargPrior, will_evict,
                          cfg: BAConfig = BAConfig(), obs_weight=None,
                          reduce=local_reduce):
    """``solve_ba`` with a pose prior, and the next prior.

    prior: MargPrior over the W poses (6-dim blocks in the T_B_W
    split-retraction tangent); while it is not valid, pose 0 is gauge-fixed
    instead (a device select, as JAX's ``lax.cond`` on ``~prior.valid``).
    will_evict: () bool. Where it is set and the solve succeeds, the
    returned prior marginalizes pose 0 of the system linearized once more
    at the result (damped with lambda 1e-5) and is rolled one slot for the
    caller's window roll; otherwise the input prior comes back unchanged.
    Same fixed-trip LM as ``solve_ba``, with the prior's terms in every
    system and its cost in every cost. `reduce` as in ``solve_ba``: the
    prior lives on the (replicated) poses, so it adds no reduction, and the
    next prior comes from the reduced system. Returns (BAResult, new
    prior).
    """
    dtype, dev = T_W_B.dtype, T_W_B.device
    W = T_W_B.shape[0]
    lm_active0 = lm_span_gate(stereo_observability_mask(obs_mask, lm_valid),
                              obs_mask, cfg.min_lm_span)
    mask0 = obs_mask & lm_active0[None, None, :]
    n_blocks, n_act0 = reduce(mask0.sum(), lm_active0.sum())
    n_vars = (W - 1) * 6 + 3 * n_act0
    attempt = (n_blocks >= cfg.min_residual_blocks) & (n_blocks * 2 >= n_vars)
    fix_first = ~prior.valid
    no_extra = torch.zeros((W, 0), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    ar = torch.arange(W, device=dev)
    gauge = torch.cat([torch.zeros(6, dtype=dtype, device=dev),
                       torch.ones((W - 1) * 6, dtype=dtype, device=dev)])

    def assemble(T_B_W, lms, mask, chi2_gate=0.0):
        """The visual blocks at T_B_W, and the prior's terms there."""
        asm = ba_assemble(T_B_W, T_C_B, lms, obs, mask, obs_weight,
                          lm_valid, cfg.huber_delta, chi2_gate)
        return asm, prior_terms(prior, lie.se3_inverse(T_B_W), no_extra)

    def system(b, lm_active, prior_t):
        """Masked normal-equation blocks plus the prior's terms and the
        total (visual + prior) cost."""
        H_pp, g_p, vis = reduce(b.H_pp, b.g_p, b.cost)
        H_add, g_add, pcost = prior_t
        g_l_m = torch.where(lm_active[:, None], b.g_l, zero)
        H_pl_m = torch.where(lm_active[None, :, None, None], b.H_pl, zero)
        sys = (H_pp, b.H_ll, H_pl_m, g_p, g_l_m, H_add, g_add)
        return sys, vis + pcost

    def lin_sys(T_B_W, lms, mask, lm_active):
        asm, prior_t = assemble(T_B_W, lms, mask)
        return system(asm.blocks, lm_active, prior_t)

    def damp_reduce(sys, lam, lm_active):
        """The damped, prior-augmented reduced camera system S, b = -grad,
        and the landmark blocks' inverses."""
        H_pp, H_ll, H_pl_m, g_p, g_l_m, H_add, g_add = sys
        H_pp_d = H_pp + lam * torch.diag_embed(_clamped_diag(H_pp))
        H_ll_d = H_ll + lam * torch.diag_embed(_clamped_diag(H_ll))
        H_ll_d = torch.where(lm_active[:, None, None], H_ll_d, eye3)
        H_ll_inv, inv_ok = _inv3x3(H_ll_d)
        A = torch.einsum("wlij,ljk->wlik", H_pl_m, H_ll_inv)
        S_blocks, b_l = reduce(-torch.einsum("wlik,vljk->wvij", A, H_pl_m),
                               torch.einsum("wlik,lk->wi", A, g_l_m))
        S_blocks[ar, ar] += H_pp_d
        S = S_blocks.permute(0, 2, 1, 3).reshape(W * 6, W * 6) + H_add
        b = (-(g_p - b_l)).reshape(W * 6) - g_add
        return S, b, H_ll_inv, inv_ok

    def solve_from_system(S, b):
        S = torch.where(fix_first, S * gauge[:, None] * gauge[None, :]
                        + torch.diag(1.0 - gauge), S)
        b = torch.where(fix_first, b * gauge, b)
        return cholesky_solve_or_nan(S, b).reshape(W, 6)

    T_B_W0 = lie.se3_inverse(T_W_B)
    sys0, cost0 = lin_sys(T_B_W0, landmarks, mask0, lm_active0)

    T_B_W, lms, sys, cost = T_B_W0, landmarks, sys0, cost0
    lam = torch.full((), cfg.lambda_init, dtype=dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = ~attempt
    status = torch.full((), STATUS_MAX_ITERATIONS, dtype=torch.int32,
                        device=dev)
    metrics = torch.zeros((cfg.max_iterations, N_METRIC_COLS), dtype=dtype,
                          device=dev)
    mask, lm_active = mask0, lm_active0
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)

    # Fixed trip count; an iteration after `done` leaves the carry as it was.
    for _ in range(cfg.max_iterations):
        live = ~done
        H_pp, H_ll, H_pl_m, g_p, g_l_m, H_add, g_add = sys
        S, b, H_ll_inv, inv_ok = damp_reduce(sys, lam, lm_active)
        delta_p = solve_from_system(S, b)
        rhs_l = -g_l_m - torch.einsum("wlij,wi->lj", H_pl_m, delta_p)
        delta_l = torch.einsum("lij,lj->li", H_ll_inv, rhs_l)
        delta_l = torch.where(lm_active[:, None], delta_l, zero)
        ok_step, dl_sq, gl_sq, gl_dl, dl_pred = _step_vote(
            reduce, torch.isfinite(delta_p).all(),
            torch.isfinite(delta_l).all() & (inv_ok | ~lm_active).all(),
            delta_l, g_l_m, _clamped_diag(H_ll))
        delta_p = torch.where(ok_step, delta_p, zero)
        delta_l = torch.where(ok_step, delta_l, zero)
        T_new = lie.se3_retract_split(T_B_W, delta_p)
        lms_new = lms + delta_l
        asm, prior_t = assemble(T_new, lms_new, mask, cfg.chi2_gate)
        sys_new, new_cost = system(asm.blocks, lm_active, prior_t)
        accept = ok_step & torch.isfinite(new_cost) & (new_cost < cost)

        mask_n, lm_active_n = mask, lm_active
        if cfg.chi2_gate > 0.0:
            # The outlier gate of solve_ba (both branches assembled in one
            # pass, one selected); the final prior is built from the gated
            # system.
            do_gate = accept & (n_acc + 1 == max(1, cfg.chi2_gate_iter))
            m, act = asm.gate_mask, asm.gate_active
            n_b, n_a = reduce(asm.n_obs, asm.n_active)
            guard = ((n_b >= cfg.min_residual_blocks)
                     & (2 * n_b >= (W - 1) * 6 + 3 * n_a))
            sys_g, cost_g = system(asm.gated, act, prior_t)
            take = do_gate & guard
            mask_n = torch.where(take, m, mask)
            lm_active_n = torch.where(take, act, lm_active)
            sys_new = _sel(take, sys_g, sys_new)
            new_cost = torch.where(take, cost_g, new_cost)
        n_acc_n = n_acc + accept.to(torch.int32)

        cost_conv = accept & (torch.abs(cost - new_cost)
                              <= cfg.cost_tol * torch.clamp(cost, min=1e-12))
        step_norm = torch.sqrt((delta_p ** 2).sum() + dl_sq)
        param_conv = accept & (step_norm <= cfg.param_tol)
        # Observer columns: the prior-augmented gradient and gain ratio.
        g_full = g_p.reshape(-1) + g_add
        g_norm = torch.sqrt((g_full ** 2).sum() + gl_sq)
        d_p = _clamped_diag(H_pp)
        pred = 0.5 * (lam * ((d_p * delta_p ** 2).sum() + dl_pred)
                      - ((g_full * delta_p.reshape(-1)).sum() + gl_dl))
        rho = step_quality(cost, new_cost, pred)
        row = metrics_row(new_cost, g_norm, lam, step_norm, rho, accept)
        metrics = torch.where(
            live & (torch.arange(cfg.max_iterations, device=dev) == it)[:, None],
            row[None, :], metrics)
        lam_n = torch.where(accept, torch.clamp(lam * 0.33, min=1e-12),
                            lam * 4.0)
        hard_fail = lam_n > cfg.lambda_max

        acc_live = accept & live
        T_B_W = torch.where(acc_live, T_new, T_B_W)
        lms = torch.where(acc_live, lms_new, lms)
        sys = _sel(acc_live, sys_new, sys)
        cost = torch.where(acc_live, new_cost, cost)
        lam = torch.where(live, lam_n, lam)
        mask = torch.where(live, mask_n, mask)
        lm_active = torch.where(live, lm_active_n, lm_active)
        n_acc = torch.where(live, n_acc_n, n_acc)
        status = torch.where(live, lm_status(cost_conv, param_conv, hard_fail),
                             status)
        it = it + live.to(torch.int32)
        done = done | (live & (cost_conv | param_conv | hard_fail))

    status = torch.where(attempt, status, torch.full_like(status,
                                                          STATUS_SKIPPED))
    finite = finite_vote(reduce, torch.isfinite(T_B_W).all(), lm_active, lms)
    success = attempt & (status != STATUS_FAILED) & finite
    T_W_B_out = torch.where(success, lie.se3_inverse(T_B_W), T_W_B)
    lms_out = torch.where(success, lms, landmarks)

    # The next prior: marginalize pose 0 of the system linearized at the
    # result (from the chi2-gated observation set when the gate is on).
    sys_f, _ = lin_sys(lie.se3_inverse(T_W_B_out), lms_out, mask,
                          lm_active)
    S_f, b_f, _, _ = damp_reduce(sys_f, 1e-5, lm_active)
    # b is -(gradient); marginalize_oldest takes the gradient.
    new_prior = marginalize_oldest(S_f, -b_f, T_W_B_out, no_extra, prior, 6)
    do_new = will_evict & success
    out_prior = MargPrior(*(torch.where(do_new, n, o)
                            for n, o in zip(new_prior, prior)))
    result = BAResult(T_W_B=T_W_B_out, landmarks=lms_out, success=success,
                      status=status, initial_cost=cost0, final_cost=cost,
                      iterations=it, metrics=metrics)
    return result, out_prior
