"""Reprojection residuals with analytic Jacobians, shared by PnP and BA,
stereo midpoint triangulation, and the N-view point-only refinement
``refine_landmarks`` (the ``refine_births`` option).

Port of rsvio_tpu/ops/projection.py. The JAX functions are per-observation
and vmapped by their callers; here every argument carries broadcastable
leading dimensions, so the solvers linearize the whole (window x camera x
landmark) observation tensor in one call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import so3_hat

CHEIRALITY_RESIDUAL = 1e3  # bounded stand-in for the reference's 1e6 sentinel


class Linearization(NamedTuple):
    r: torch.Tensor        # (..., 2) whitened residual (sqrt-Huber applied)
    J_pose: torch.Tensor   # (..., 2, 6) whitened d r / d [dt, dw] of T_B_W
    J_lm: torch.Tensor     # (..., 2, 3) whitened d r / d p_W
    valid: torch.Tensor    # (...) in front of the camera and mask passed
    cost: torch.Tensor     # (...) robust cost rho(||r||^2)


def proj_jacobian(p_cam):
    """(..., 3) -> (..., 2, 3) Jacobian of (x/z, y/z)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    z_safe = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([iz, zero, -x * iz2], dim=-1),
        torch.stack([zero, iz, -y * iz2], dim=-1),
    ], dim=-2)


def huber_weight(r_sq, delta: float):
    """IRLS weight of the Huber loss: 1 inside delta, delta/||r|| outside."""
    r_norm = torch.sqrt(torch.clamp(r_sq, min=1e-18))
    return torch.where(r_norm <= delta, torch.ones_like(r_norm),
                       delta / r_norm)


def huber_cost(r_sq, delta: float):
    """Huber rho: 0.5||r||^2 inside delta, delta(||r|| - delta/2) outside."""
    r_norm = torch.sqrt(torch.clamp(r_sq, min=1e-18))
    return torch.where(r_norm <= delta, 0.5 * r_sq,
                       delta * (r_norm - 0.5 * delta))


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def linearize_projection(T_C_B, T_B_W, p_W, obs, mask,
                         huber_delta: float = 2.0) -> Linearization:
    """Linearize reprojection observations (broadcast over leading dims).

    T_C_B (..., 4, 4) camera-from-body, T_B_W (..., 4, 4) body-from-world
    (the solver variable), p_W (..., 3), obs (..., 2) normalized coords,
    mask (...) bool. Behind-camera observations get a constant residual and
    zero Jacobian; masked-out observations contribute nothing.
    """
    R_B_W = T_B_W[..., :3, :3]
    p_B = _mv(R_B_W, p_W) + T_B_W[..., :3, 3]
    R_C_B = T_C_B[..., :3, :3]
    p_C = _mv(R_C_B, p_B) + T_C_B[..., :3, 3]

    in_front = p_C[..., 2] > 1e-6
    valid = mask & in_front
    z_safe = torch.where(in_front, p_C[..., 2], torch.ones_like(p_C[..., 2]))
    proj = torch.stack([p_C[..., 0] / z_safe, p_C[..., 1] / z_safe], dim=-1)
    r = proj - obs
    r = torch.where(in_front[..., None], r,
                    torch.full_like(r, CHEIRALITY_RESIDUAL))
    r = torch.where(mask[..., None], r, torch.zeros_like(r))

    Jpi = proj_jacobian(p_C)                       # (...,2,3)
    RR = R_C_B @ R_B_W
    J_t = Jpi @ R_C_B                              # d r / d t_B_W
    J_w = Jpi @ (RR @ (-so3_hat(p_W)))             # d r / d omega
    J_pose = torch.cat([J_t, J_w], dim=-1)         # (...,2,6)
    J_lm = Jpi @ RR                                # (...,2,3)

    maskf = mask.to(r.dtype)
    r_sq = (r * r).sum(-1) * maskf
    w = huber_weight(r_sq, huber_delta)
    sw = torch.sqrt(w) * valid.to(r.dtype)
    cost = huber_cost(r_sq, huber_delta) * maskf
    return Linearization(r=r * sw[..., None],
                         J_pose=J_pose * sw[..., None, None],
                         J_lm=J_lm * sw[..., None, None],
                         valid=valid, cost=cost)


def projection_cost(T_C_B, T_B_W, p_W, obs, mask, huber_delta: float = 2.0):
    """Robust cost of observations (for LM accept / reject), broadcast over
    leading dims as linearize_projection, whose cost field it equals:
    behind the camera the residual is CHEIRALITY_RESIDUAL, a masked-out
    observation costs 0."""
    p_B = _mv(T_B_W[..., :3, :3], p_W) + T_B_W[..., :3, 3]
    p_C = _mv(T_C_B[..., :3, :3], p_B) + T_C_B[..., :3, 3]
    in_front = p_C[..., 2] > 1e-6
    z_safe = torch.where(in_front, p_C[..., 2], torch.ones_like(p_C[..., 2]))
    proj = torch.stack([p_C[..., 0] / z_safe, p_C[..., 1] / z_safe], dim=-1)
    r = torch.where(in_front[..., None], proj - obs,
                    torch.full_like(proj, CHEIRALITY_RESIDUAL))
    return huber_cost((r * r).sum(-1), huber_delta) * mask.to(r.dtype)


def triangulate_stereo(T_W_Cl, T_W_Cr, xy_l, xy_r):
    """Midpoint triangulation from a stereo pair of normalized observations.

    T_W_Cl/T_W_Cr (..., 4, 4); xy_l/xy_r (..., 2). Returns (p_W (..., 3),
    valid (...)): valid needs non-parallel rays and positive depth along
    both.
    """
    o1, o2 = T_W_Cl[..., :3, 3], T_W_Cr[..., :3, 3]
    one = torch.ones_like(xy_l[..., :1])
    d1 = _mv(T_W_Cl[..., :3, :3], torch.cat([xy_l, one], dim=-1))
    d2 = _mv(T_W_Cr[..., :3, :3], torch.cat([xy_r, one], dim=-1))
    d1 = d1 / torch.clamp(torch.linalg.vector_norm(d1, dim=-1), min=1e-9)[..., None]
    d2 = d2 / torch.clamp(torch.linalg.vector_norm(d2, dim=-1), min=1e-9)[..., None]
    a = (d1 * d1).sum(-1)
    b = (d1 * d2).sum(-1)
    c = (d2 * d2).sum(-1)
    rhs = o2 - o1
    det = a * c - b * b
    det_safe = torch.where(torch.abs(det) > 1e-9, det,
                           torch.full_like(det, 1e-9))
    d1r = (d1 * rhs).sum(-1)
    d2r = (d2 * rhs).sum(-1)
    s = (c * d1r - b * d2r) / det_safe
    t = (b * d1r - a * d2r) / det_safe
    p = 0.5 * ((o1 + s[..., None] * d1) + (o2 + t[..., None] * d2))
    valid = (torch.abs(det) > 1e-6) & (s > 1e-3) & (t > 1e-3)
    return p, valid


def refine_landmarks(T_C_B, T_B_W, landmarks, obs, mask,
                     iterations: int = 5, huber_delta: float = 2.0,
                     lm_lambda: float = 1e-6):
    """N-view point-only refinement: Gauss-Newton over each landmark with
    every camera pose fixed.

    T_C_B (2,4,4) camera-from-body, T_B_W (W,4,4) body-from-world (fixed),
    landmarks (L,3) initial points, obs (W,2,L,2) normalized observations,
    mask (W,2,L). Each landmark's step is a closed-form damped 3x3 solve,
    kept only where it is finite and does not raise the robust cost. The
    JAX ``fori_loop`` becomes the same fixed trip of `iterations` over all
    landmarks at once: no early exit, no host sync. Returns (landmarks
    (L,3), ok (L,)); ok needs >= 2 observations, a well-conditioned final
    system and a finite point, and a landmark without it comes back
    unchanged.
    """
    from ..models.ba import _inv3x3

    eye = torch.eye(3, dtype=landmarks.dtype, device=landmarks.device)
    n_obs = mask.sum(dim=(0, 1))                          # (L,)

    def lin(p):
        """Normal equations and robust cost of every landmark at p:
        H (L,3,3), g (L,3), cost (L,)."""
        li = linearize_projection(T_C_B[None, :, None], T_B_W[:, None, None],
                                  p[None, None], obs, mask, huber_delta)
        return (torch.einsum("wclri,wclrj->lij", li.J_lm, li.J_lm),
                torch.einsum("wclri,wclr->li", li.J_lm, li.r),
                li.cost.sum(dim=(0, 1)))

    p = landmarks
    H, g, cost = lin(p)
    for _ in range(iterations):
        H_inv, inv_ok = _inv3x3(H + lm_lambda * eye)
        p_new = p - _mv(H_inv, g)
        H_n, g_n, cost_n = lin(p_new)
        ok = (inv_ok & torch.isfinite(p_new).all(dim=-1)
              & (cost_n <= cost))
        p = torch.where(ok[:, None], p_new, p)
        H = torch.where(ok[:, None, None], H_n, H)
        g = torch.where(ok[:, None], g_n, g)
        cost = torch.where(ok, cost_n, cost)
    _, cond_ok = _inv3x3(H + lm_lambda * eye)
    ok = (n_obs >= 2) & cond_ok & torch.isfinite(p).all(dim=-1)
    return torch.where(ok[:, None], p, landmarks), ok
