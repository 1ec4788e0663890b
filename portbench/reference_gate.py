"""The plain reference of the RANSAC consensus gate that the adaptive
profile (configs/euroc_vo_adaptive.json, the repository's
config/euroc_vo_adaptive.yaml) switches on, with the rules drawn from its
vote: the track health, the motion prior's scale and the outlier kill.

Plain PyTorch in float64 on the CPU, one hypothesis at a time: no batching,
no fused path, Jacobians from torch.autograd. It imports nothing of the
program. Its semantics are those of the JAX package's
``models/pnp.py:ransac_pnp_gate`` and of ``models/estimator.py:run_motion``'s
health, prior and kill rules:

- K minimal samples of S observations, Gumbel-top-S over the valid
  observations of both cameras (2L of them), each index scored by its
  Gumbel draw plus the log of its track's weight clip(age / cap, floor, 1);
  ties keep the lower index first (as ``lax.top_k``);
- per hypothesis, ``gn_iters`` damped Gauss-Newton steps from the seed
  pose: residuals whitened by the square root of the Huber weight of
  ``huber_delta`` at the linearization point, H = J^T J + 1e-4 I, a step
  with a non-finite entry is dropped, the split retraction t += dt,
  R <- R exp(dw) of the body-from-world pose; an observation masked off or
  behind the camera (z <= 1e-6) contributes nothing;
- verification of every observation against every hypothesis: the squared
  reprojection error, infinite behind the camera, under threshold^2, and a
  hypothesis with a non-finite pose has no inliers;
- the age-weighted vote, argmax taking the first maximum; the consensus
  floor (``min_inliers``) on the unweighted count of the winner and of the
  valid observations; below it the gate passes the mask through;
- health: the winner's inlier fraction of the candidates ramped between
  f_lo and f_hi, ``health_floor`` when the gate found no consensus, and
  with hysteresis (``health_recover`` < 1) at most the previous health plus
  ``health_recover``; the prior's scale 1 - health; the kill set: tracks
  with a candidate observation outside the winning set, when the gate won
  and the pose polish succeeded.

Departures from the JAX package, each the program's too:

- The draws are an input (the JAX package draws them from a threefry key,
  which torch cannot reproduce).
- Where floor x cap is an integer (the shipped 0.1 x 10), the vote is the
  exact integer sum of clip(age, floor x cap, cap), which ranks the
  hypotheses as the weighted float sum does but keeps an exact tie a tie,
  so the lowest index wins it (ROADMAP C4). Elsewhere the vote is the
  float64 sum of the weights.
- The pose polish (``solve_pnp``) is not part of this reference: the kill
  set takes its success as an input.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# The comparison must not run in a lower precision than it states, on any
# device this module's functions are handed.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
Z_MIN = 1e-6          # in front of the camera: z > Z_MIN
DAMPING = 1e-4        # the minimal solves' H = J^T J + DAMPING I


class GateParams(NamedTuple):
    """The gate's and the health's settings; the defaults are the JAX
    package's (PnPConfig, EstimatorConfig, SolverConfig)."""
    hypotheses: int = 16
    sample: int = 4
    gn_iters: int = 4
    threshold: float = 8e-3
    min_inliers: int = 12
    age_cap: int = 10
    age_floor: float = 0.1
    huber_delta: float = 2.0
    health_f_lo: float = 0.5
    health_f_hi: float = 0.9
    health_floor: float = 0.1
    health_recover: float = 1.0
    kill: bool = True
    prior_adaptive: bool = False


def params_from_config(config: dict) -> GateParams:
    """GateParams from a configuration's sections (a benchmark
    configuration file's ``config``, the YAML's keys)."""
    s = config.get("solver", {})
    d = GateParams()
    return GateParams(
        hypotheses=int(s.get("ransac_hypotheses", 0)),
        threshold=float(s.get("ransac_threshold", d.threshold)),
        min_inliers=int(s.get("ransac_min_inliers", d.min_inliers)),
        huber_delta=float(s.get("huber_delta", d.huber_delta)),
        health_f_lo=float(s.get("health_f_lo", d.health_f_lo)),
        health_f_hi=float(s.get("health_f_hi", d.health_f_hi)),
        health_floor=float(s.get("health_floor", d.health_floor)),
        health_recover=float(s.get("health_recover", d.health_recover)),
        kill=bool(s.get("ransac_kill_outliers", d.kill)),
        prior_adaptive=bool(s.get("pnp_prior_adaptive", d.prior_adaptive)))


class Gate(NamedTuple):
    idx: list            # K lists of S flat indices (cam * L + slot)
    T_hyp: torch.Tensor  # (K,4,4) body-from-world hypotheses
    r2: torch.Tensor     # (K,2,L) squared reprojection errors (inf behind)
    inliers: torch.Tensor  # (K,2,L) bool
    votes: list          # K votes (int, or float off the integer grid)
    best: int
    runner_up: float     # the best vote among the other hypotheses
    best_count: int
    n_valid: int
    ok: bool
    inlier_mask: torch.Tensor  # (2,L) the winning set, or the mask


def candidates(obs_mask, lm_fid, table_fid, alive):
    """The gate's observation mask (2,L): a current observation of a live
    track whose landmark belongs to it."""
    lm_ok = (lm_fid == table_fid) & (lm_fid >= 0) & alive
    return obs_mask.bool() & lm_ok[None, :]


def _hat(w):
    z = torch.zeros((), dtype=w.dtype)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def _so3_exp(w):
    """Rodrigues, with its series below theta^2 = 1e-8 (smooth at 0, so
    autograd gives the exact derivative there)."""
    th2 = (w * w).sum()
    W = _hat(w)
    if float(th2.detach()) < 1e-8:
        a, b = 1.0 - th2 / 6.0, 0.5 - th2 / 24.0
    else:
        th = torch.sqrt(th2)
        a, b = torch.sin(th) / th, (1.0 - torch.cos(th)) / th2
    return torch.eye(3, dtype=w.dtype) + a * W + b * (W @ W)


def retract(T, delta):
    """The solvers' split retraction of a body-from-world pose."""
    out = torch.eye(4, dtype=T.dtype)
    out[:3, :3] = T[:3, :3] @ _so3_exp(delta[3:])
    out[:3, 3] = T[:3, 3] + delta[:3]
    return out


def _retract_diff(T, delta):
    """retract, built without in-place writes (for autograd)."""
    R = T[:3, :3] @ _so3_exp(delta[3:])
    t = T[:3, 3] + delta[:3]
    return R, t


def inverse(T):
    out = torch.eye(4, dtype=T.dtype)
    R = T[:3, :3].T
    out[:3, :3] = R
    out[:3, 3] = -(R @ T[:3, 3])
    return out


def sample(gumbel, mask, age, p: GateParams):
    """Each hypothesis' S flat indices (cam * L + slot), Gumbel-top-S over
    the valid observations, the lower index first on a tie."""
    L = mask.shape[1]
    flat_mask = mask.reshape(-1).tolist()
    logw = [math.log(w) for w in vote_weights(age, p, L)] * 2
    out = []
    for k in range(gumbel.shape[0]):
        g = gumbel[k].to(F64).tolist()
        scores = [g[i] + logw[i] if flat_mask[i] else -math.inf
                  for i in range(2 * L)]
        order = sorted(range(2 * L), key=lambda i: (-scores[i], i))
        out.append(order[:p.sample])
    return out


def vote_weights(age, p: GateParams, L: int):
    """clip(age / cap, floor, 1) per slot (1 without ages)."""
    if age is None or p.age_cap <= 0:
        return [1.0] * L
    return [min(max(a / p.age_cap, p.age_floor), 1.0)
            for a in age.to(F64).tolist()]


def _huber_sqrt_weight(r_sq: float, delta: float) -> float:
    n = math.sqrt(max(r_sq, 1e-18))
    return 1.0 if n <= delta else math.sqrt(delta / n)


def solve_hypothesis(T_B_W0, T_C_B, landmarks, obs, mask, picks,
                     p: GateParams):
    """One hypothesis: gn_iters damped Gauss-Newton steps over its picks
    (flat indices) from T_B_W0."""
    L = landmarks.shape[0]
    T = T_B_W0.clone()
    for _ in range(p.gn_iters):
        rows, weights = [], []
        for i in picks:
            c, l = divmod(i, L)
            if not bool(mask[c, l]):
                continue
            p_C = T_C_B[c, :3, :3] @ (T[:3, :3] @ landmarks[l] + T[:3, 3]) \
                + T_C_B[c, :3, 3]
            if float(p_C[2]) <= Z_MIN:
                continue
            r = p_C[:2] / p_C[2] - obs[c, l]
            rows.append((c, l))
            weights.append(_huber_sqrt_weight(float((r * r).sum()),
                                              p.huber_delta))
        if not rows:
            continue

        def residuals(delta):
            R, t = _retract_diff(T, delta)
            out = []
            for (c, l), sw in zip(rows, weights):
                p_C = T_C_B[c, :3, :3] @ (R @ landmarks[l] + t) \
                    + T_C_B[c, :3, 3]
                out.append(sw * (p_C[:2] / p_C[2] - obs[c, l]))
            return torch.cat(out)

        zero = torch.zeros(6, dtype=F64)
        r = residuals(zero).detach()
        J = torch.autograd.functional.jacobian(residuals, zero,
                                               vectorize=True)
        H = J.T @ J + DAMPING * torch.eye(6, dtype=F64)
        delta = -torch.linalg.solve(H, J.T @ r)
        if bool(torch.isfinite(delta).all()):
            T = retract(T, delta)
    return T


def verify(T_B_W, T_C_B, landmarks, obs, mask, p: GateParams):
    """(r2 (2,L), inliers (2,L)) of one hypothesis."""
    r2 = torch.empty(mask.shape, dtype=F64)
    for c in range(2):
        p_C = (T_C_B[c, :3, :3] @ (landmarks @ T_B_W[:3, :3].T
                                    + T_B_W[:3, 3]).T).T + T_C_B[c, :3, 3]
        front = p_C[:, 2] > Z_MIN
        z = torch.where(front, p_C[:, 2], torch.ones_like(p_C[:, 2]))
        e = ((p_C[:, :2] / z[:, None] - obs[c]) ** 2).sum(-1)
        r2[c] = torch.where(front, e, torch.full_like(e, math.inf))
    finite = bool(torch.isfinite(T_B_W).all())
    return r2, mask & (r2 < p.threshold ** 2) & finite


def integral_floor(p: GateParams):
    lo = p.age_floor * p.age_cap
    return int(round(lo)) if abs(lo - round(lo)) <= 1e-9 else None


def vote(inliers, age, p: GateParams):
    """One hypothesis' age-weighted vote (an int on the integer grid)."""
    L = inliers.shape[1]
    lo = integral_floor(p)
    if age is None or p.age_cap <= 0:
        return int(inliers.sum())
    if lo is not None:
        w = [min(max(int(a), lo), p.age_cap) for a in age.tolist()]
    else:
        w = vote_weights(age, p, L)
    flags = inliers.tolist()
    return sum(w[l] for c in range(2) for l in range(L) if flags[c][l])


def ransac_gate(T_W_B_seed, T_C_B, landmarks, obs, mask, gumbel, age,
                p: GateParams) -> Gate:
    """The gate on one frame. T_W_B_seed (4,4) seeds every hypothesis;
    T_C_B (2,4,4); landmarks (L,3) the frozen birth map; obs (2,L,2)
    normalized; mask (2,L) the candidates; gumbel (K, 2L); age (L,) or
    None. Every tensor is taken to float64 on the CPU."""
    T_W_B_seed, T_C_B, landmarks, obs = (
        t.detach().to("cpu", F64) for t in (T_W_B_seed, T_C_B, landmarks,
                                            obs))
    mask = mask.detach().cpu().bool()
    age = None if age is None else age.detach().cpu()
    T0 = inverse(T_W_B_seed)
    picks = sample(gumbel.detach().cpu(), mask, age, p)
    T_hyp, r2s, inls, votes = [], [], [], []
    for k in range(len(picks)):
        T = solve_hypothesis(T0, T_C_B, landmarks, obs, mask, picks[k], p)
        r2, inl = verify(T, T_C_B, landmarks, obs, mask, p)
        T_hyp.append(T)
        r2s.append(r2)
        inls.append(inl)
        votes.append(vote(inl, age, p))
    best = 0
    for k in range(1, len(votes)):
        if votes[k] > votes[best]:
            best = k
    others = [v for k, v in enumerate(votes) if k != best]
    best_count = int(inls[best].sum())
    n_valid = int(mask.sum())
    ok = best_count >= p.min_inliers and n_valid >= p.min_inliers
    return Gate(idx=picks, T_hyp=torch.stack(T_hyp), r2=torch.stack(r2s),
                inliers=torch.stack(inls), votes=votes, best=best,
                runner_up=max(others) if others else -math.inf,
                best_count=best_count, n_valid=n_valid, ok=ok,
                inlier_mask=inls[best] if ok else mask)


def health(gate: Gate, n_candidates: int, p: GateParams,
           health_prev=None) -> float:
    """The frame's track health from a gate that ran."""
    if gate.ok:
        f = gate.best_count / max(n_candidates, 1)
        h = min(max((f - p.health_f_lo)
                    / max(p.health_f_hi - p.health_f_lo, 1e-6), 0.0), 1.0)
    else:
        h = p.health_floor
    if p.health_recover < 1.0 and health_prev is not None:
        h = min(h, float(health_prev) + p.health_recover)
    return h


def prior_scale(h: float, p: GateParams):
    """The motion prior's weight factor (None: the prior is not scaled)."""
    return 1.0 - h if p.prior_adaptive else None


def kill(gate: Gate, mask, pnp_success: bool, p: GateParams):
    """(L,) tracks the step excises before the window insert."""
    mask = mask.detach().cpu().bool()
    out = (mask & ~gate.inlier_mask).any(dim=0)
    return out & (p.kill and gate.ok and bool(pnp_success))
