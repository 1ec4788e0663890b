"""Distributed visual-inertial BA: the landmark-sharded Schur reduction of
parallel.dist_ba with the IMU factors replicated.

Port of rsvio_tpu/parallel/dist_vio_ba.py. The visual observations are
sharded over landmarks as in the VO case; the IMU preintegration factors
and the marginalization prior touch only the (replicated) keyframe states,
so every rank linearizes them alike with no communication. Per LM
iteration the collectives are the all-reduces of the visual pose blocks
and cost, of the 6-dim Schur correction to the (W·15)^2 state system, and
of the step's vote and metric pieces (two more with the chi^2 gate).

The loop is models/vio_ba.py's ``_solve`` with the mesh's all-reduce as its
``reduce`` hook. The marginalized solve's eviction prior is
``models.vio_ba.build_eviction_prior`` on the global result: the
landmarks and state 0's final (chi^2-gated) observation mask are
all-gathered first, so every rank builds the same prior.
"""

from __future__ import annotations

from ..models import vio_ba
from ..models.marginalization import MargPrior
from ..models.vio_ba import VIOBAConfig, VIOState
from .dist_ba import _shard_args
from .mesh import Mesh


def _solve_sharded(mesh: Mesh, state, T_C_B, landmarks, obs, obs_mask,
                   lm_valid, preint, preint_valid, cfg, fix_first,
                   obs_weight, bias_alpha, prior):
    lms, obs_s, mask, valid, w = _shard_args(mesh, landmarks, obs, obs_mask,
                                             lm_valid, obs_weight)
    res, mask_f, sqrt_infos = vio_ba._solve(
        state, T_C_B, lms, obs_s, mask, valid, preint, preint_valid, cfg,
        fix_first, w, bias_alpha, prior, reduce=mesh.all_reduce_packed)
    return (res._replace(landmarks=mesh.all_gather(res.landmarks)), mask_f,
            sqrt_infos)


def solve_vio_ba_distributed(mesh: Mesh, state: VIOState, T_C_B, landmarks,
                             obs, obs_mask, lm_valid, preint, preint_valid,
                             cfg: VIOBAConfig = VIOBAConfig(),
                             fix_first: bool = True, obs_weight=None,
                             bias_alpha=None) -> vio_ba.VIOBAResult:
    """Landmark-sharded ``models.vio_ba.solve_vio_ba`` over `mesh` (same
    contract); the landmark count must divide by the mesh size."""
    return _solve_sharded(mesh, state, T_C_B, landmarks, obs, obs_mask,
                          lm_valid, preint, preint_valid, cfg, fix_first,
                          obs_weight, bias_alpha, None)[0]


def solve_vio_ba_marginalized_distributed(mesh: Mesh, state: VIOState, T_C_B,
                                          landmarks, obs, obs_mask, lm_valid,
                                          preint, preint_valid,
                                          prior: MargPrior, will_evict,
                                          cfg: VIOBAConfig = VIOBAConfig(),
                                          obs_weight=None, bias_alpha=None):
    """Landmark-sharded ``models.vio_ba.solve_vio_ba_marginalized`` over
    `mesh`: returns (VIOBAResult, new MargPrior)."""
    res, mask_f, sqrt_infos = _solve_sharded(
        mesh, state, T_C_B, landmarks, obs, obs_mask, lm_valid, preint,
        preint_valid, cfg, True, obs_weight, bias_alpha, prior)
    return res, vio_ba.next_prior(
        res, T_C_B, obs[0], mesh.all_gather(mask_f[0], dim=1), preint,
        preint_valid, sqrt_infos[0], prior, will_evict, cfg,
        None if obs_weight is None else obs_weight[0])
