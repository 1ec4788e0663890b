"""Distributed per-frame estimators: the VO and VIO steps with the window
solve landmark-sharded over a mesh.

Port of rsvio_tpu/parallel/dist_estimator.py. The frontend, the motion
stage and the keyframe policy run replicated on every rank (the image work
of one camera pair does not shard usefully), and the window solve — the
cost that grows with window x landmark capacity — runs as the sharded
solvers of parallel.dist_ba / parallel.dist_vio_ba.

JAX assembles the distributed step anew from its stages because
``shard_map`` under ``lax.cond`` deadlocks. The port's single-device steps
already branch on the host on ``is_kf`` and ``full_now``, and their window
solve is one closure over a pair of solver functions, so the distributed
steps ARE the single-device steps (models.estimator.make_estimator_step,
models.estimator_vio.make_vio_estimator_step) with the sharded solvers
passed in: every stage, option and host branch is shared.

Every rank must make the same collectives in the same order. The host
branches read only replicated values (``is_kf``, ``full_now``, the IMU
interval's count), which agree across ranks because every rank runs the
same frontend on the same images with the same draws (the RANSAC gate's
generator is seeded by the frame id); the solvers' loops are fixed-trip.
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace

from ..models import estimator as est
from ..models import estimator_vio as ev
from . import dist_ba, dist_vio_ba
from .mesh import Mesh


def _check_capacity(capacity: int, mesh: Mesh) -> None:
    if capacity % mesh.size:
        raise ValueError(f"capacity {capacity} not divisible by mesh size "
                         f"{mesh.size}")


def make_distributed_estimator_step(cfg: est.EstimatorConfig, mesh: Mesh,
                                    draws=est.gumbel_draws, probe=None):
    """The VO step (state, rig, img0, img1) -> (state, FrameOutput) with
    the window BA landmark-sharded over `mesh`: every rank calls it on the
    same state and images (on its mesh device) and gets the same result.
    The landmark capacity (cfg.frontend.capacity) must divide by the mesh
    size. `draws`, `probe` as in make_estimator_step."""
    _check_capacity(cfg.frontend.capacity, mesh)
    return est.make_estimator_step(cfg, draws, probe, SimpleNamespace(
        solve_ba=partial(dist_ba.solve_ba_distributed, mesh),
        solve_ba_marginalized=partial(
            dist_ba.solve_ba_marginalized_distributed, mesh)))


def make_distributed_vio_estimator_step(vcfg: ev.VIOEstimatorConfig,
                                        mesh: Mesh, draws=est.gumbel_draws,
                                        probe=None):
    """The VIO step (state, rig, img0, img1, gyro, accel, dts, imu_mask)
    -> (state, FrameOutput) with the joint 15-dim window solve
    landmark-sharded over `mesh`; as make_distributed_estimator_step."""
    _check_capacity(vcfg.base.frontend.capacity, mesh)
    return ev.make_vio_estimator_step(vcfg, draws, probe, SimpleNamespace(
        solve_vio_ba=partial(dist_vio_ba.solve_vio_ba_distributed, mesh),
        solve_vio_ba_marginalized=partial(
            dist_vio_ba.solve_vio_ba_marginalized_distributed, mesh)))
