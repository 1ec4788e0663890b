"""Distributed sliding-window BA: the landmark blocks sharded over a mesh's
ranks, the Schur reduction summed by all-reduce.

Port of rsvio_tpu/parallel/dist_ba.py. The BA normal equations

    [ H_pp  H_pl ] [dp]   [-g_p]
    [ H_lp  H_ll ] [dl] = [-g_l]

have a block-diagonal H_ll, so with the landmarks (and their observation
columns) split over the ranks the linearization and the landmark
elimination are local, and only the pose blocks, the reduced camera system

    S = H_pp - sum_l H_pl[l] H_ll[l]^-1 H_lp[l]      ((W·6)^2, small)

and a few scalars are summed over the ranks: per LM iteration one packed
all-reduce each for the Schur system, the step's validity vote with its
metric pieces and the relinearization's pose blocks and cost (two more with
the chi^2 gate). Every rank solves the same S by Cholesky and
back-substitutes its own landmarks. The bytes per iteration do not depend
on the landmark count.

The LM loop is models/ba.py's own, given the mesh's all-reduce as its
``reduce`` hook (the identity on one device): the sharded solve makes
exactly the single-device solve's arithmetic on each shard, and JAX's
copies of the loop (``shard_map`` bodies) have no counterpart here. The
loop is fixed-trip, so every rank makes the same collectives in the same
order whatever its shard holds.

Contract, JAX's: every rank is given the global (replicated) arrays; the
function takes its own landmark shard, solves, and returns the global
result, the landmarks all-gathered once at the end. The landmark count
must divide by the mesh size.
"""

from __future__ import annotations

from ..models import ba as ba_mod
from .mesh import Mesh


def _shard_args(mesh: Mesh, landmarks, obs, obs_mask, lm_valid, obs_weight):
    sl = mesh.shard(landmarks.shape[0])
    return (landmarks[sl], obs[:, :, sl], obs_mask[:, :, sl], lm_valid[sl],
            None if obs_weight is None else obs_weight[:, sl])


def solve_ba_distributed(mesh: Mesh, T_W_B, T_C_B, landmarks, obs, obs_mask,
                         lm_valid, cfg: ba_mod.BAConfig = ba_mod.BAConfig(),
                         obs_weight=None) -> ba_mod.BAResult:
    """Landmark-sharded ``models.ba.solve_ba`` over `mesh` (same contract,
    optional (W,L) obs_weight included; JAX's ``fix_first`` flag is not
    taken, as the port's solve_ba always fixes the first pose). Raises
    ValueError when L does not divide by the mesh size."""
    lms, obs, mask, valid, w = _shard_args(mesh, landmarks, obs, obs_mask,
                                           lm_valid, obs_weight)
    res = ba_mod.solve_ba(T_W_B, T_C_B, lms, obs, mask, valid, cfg,
                          obs_weight=w, reduce=mesh.all_reduce_packed)
    return res._replace(landmarks=mesh.all_gather(res.landmarks))


def solve_ba_marginalized_distributed(mesh: Mesh, T_W_B, T_C_B, landmarks,
                                      obs, obs_mask, lm_valid, prior,
                                      will_evict,
                                      cfg: ba_mod.BAConfig = ba_mod.BAConfig(),
                                      obs_weight=None):
    """Landmark-sharded ``models.ba.solve_ba_marginalized`` over `mesh`:
    returns (BAResult, new MargPrior). The prior lives on the replicated
    poses, so it adds no communication; the next prior marginalizes the
    all-reduced system at the result, replicated on every rank."""
    lms, obs, mask, valid, w = _shard_args(mesh, landmarks, obs, obs_mask,
                                           lm_valid, obs_weight)
    res, prior = ba_mod.solve_ba_marginalized(
        T_W_B, T_C_B, lms, obs, mask, valid, prior, will_evict, cfg,
        obs_weight=w, reduce=mesh.all_reduce_packed)
    return res._replace(landmarks=mesh.all_gather(res.landmarks)), prior
