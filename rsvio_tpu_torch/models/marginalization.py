"""Marginalization: when the oldest keyframe leaves the sliding window, its
constraints are absorbed into a dense Gaussian prior over the remaining
states instead of being dropped.

Port of rsvio_tpu/models/marginalization.py. Given the linearized system
H dx = -g over [x_m (marginalized), x_r (remaining)] at x0, the marginal
over x_r is the Schur complement

    H_prior = H_rr - H_rm H_mm^-1 H_mr,   g_prior = g_r - H_rm H_mm^-1 g_m,

applied at later iterates as H_prior (x boxminus x0_r) + g_prior with the
linearization point x0_r frozen (first-estimate Jacobians). The prior is a
dense (W*B)^2 matrix over the whole window with zero blocks where it holds
no information, so the VIO (B = 15) and distributed solvers can use the
same functions; rolling the window shifts its blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie


class MargPrior(NamedTuple):
    """Gaussian prior over the window states (block layout (W, W, B, B))."""
    H: torch.Tensor         # (W*B, W*B)
    g: torch.Tensor         # (W*B,)
    T0: torch.Tensor        # (W,4,4) linearization point, T_W_B
    x0_extra: torch.Tensor  # (W, B-6)
    valid: torch.Tensor     # () bool


def empty_prior(W: int, B: int, dtype=torch.float32,
                device="cuda") -> MargPrior:
    return MargPrior(
        H=torch.zeros((W * B, W * B), dtype=dtype, device=device),
        g=torch.zeros(W * B, dtype=dtype, device=device),
        T0=torch.eye(4, dtype=dtype, device=device).expand(W, 4, 4).clone(),
        x0_extra=torch.zeros((W, max(B - 6, 0)), dtype=dtype, device=device),
        valid=torch.tensor(False, device=device),
    )


def state_boxminus(T_W_B, extra, prior: MargPrior):
    """dx = x boxminus x0 (W, B) in the solvers' tangent convention (split
    retraction on T_B_W: translation additive, rotation right-multiplied).
    """
    Tb = lie.se3_inverse(T_W_B)
    Tb0 = lie.se3_inverse(prior.T0)
    dt = Tb[:, :3, 3] - Tb0[:, :3, 3]
    dw = lie.so3_log(Tb0[:, :3, :3].transpose(-1, -2) @ Tb[:, :3, :3])
    return torch.cat([dt, dw, extra - prior.x0_extra], dim=1)


def prior_terms(prior: MargPrior, T_W_B, extra):
    """(H_add (W*B, W*B), g_add (W*B,), cost) to add to an LM iteration;
    all zero while the prior is not valid."""
    W = T_W_B.shape[0]
    B = prior.H.shape[0] // W
    dx = state_boxminus(T_W_B, extra, prior).reshape(W * B)
    validf = prior.valid.to(prior.H.dtype)
    H = prior.H * validf
    g = (prior.g + prior.H @ dx) * validf
    cost = (0.5 * dx @ prior.H @ dx + prior.g @ dx) * validf
    return H, g, cost


def marginalize_oldest(H_full, g_full, T_W_B, extra, prior_in: MargPrior,
                       B: int, eps: float = 1e-5) -> MargPrior:
    """Absorb state 0 of a linearized window system into a new prior and
    shift it down one slot, as the window roll will.

    H_full (W*B, W*B) is the linearized Hessian with the current prior in
    it, g_full (W*B,) the gradient at the linearization point (T_W_B,
    extra); prior_in is not read (the JAX signature). The marginalized
    block gets the relative ridge eps * max|diag H_mm|, the result is
    symmetrized and gets a second ridge 1e-5 * max|diag H_p| (the gauge
    directions carry no information; roundoff would otherwise let LM walk
    along them). H_mm^-1 is a Cholesky solve that yields NaN rather than
    raising on a block that is not positive definite, as
    ``jax.scipy.linalg.cho_factor`` does. Returns the prior over the rolled
    window, its last slot empty and T0 / x0_extra rolled with it.
    """
    from .ba import cholesky_solve_or_nan

    W = H_full.shape[0] // B
    dtype, dev = H_full.dtype, H_full.device
    mm_scale = torch.clamp(torch.diagonal(H_full[:B, :B]).abs().max(),
                           min=1.0)
    H_mm = H_full[:B, :B] + (eps * mm_scale) * torch.eye(B, dtype=dtype,
                                                         device=dev)
    H_mr = H_full[:B, B:]
    H_rr = H_full[B:, B:]
    X = cholesky_solve_or_nan(H_mm, H_mr)               # H_mm^-1 H_mr
    H_p = H_rr - H_mr.T @ X
    g_p = g_full[B:] - X.T @ g_full[:B]
    H_p = 0.5 * (H_p + H_p.T)
    scale = torch.clamp(torch.diagonal(H_p).abs().max(), min=1.0)
    H_p = H_p + (1e-5 * scale) * torch.eye(H_p.shape[0], dtype=dtype,
                                           device=dev)
    n_r = (W - 1) * B
    H_out = torch.zeros((W * B, W * B), dtype=dtype, device=dev)
    H_out[:n_r, :n_r] = H_p
    g_out = torch.zeros(W * B, dtype=dtype, device=dev)
    g_out[:n_r] = g_p
    return MargPrior(H=H_out, g=g_out,
                     T0=torch.cat([T_W_B[1:], T_W_B[-1:]]),
                     x0_extra=torch.cat([extra[1:], extra[-1:]]),
                     valid=torch.ones((), dtype=torch.bool, device=dev))
