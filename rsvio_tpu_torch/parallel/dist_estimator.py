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

The compiled distributed steps (make_compiled_distributed_estimator_step,
make_compiled_distributed_vio_estimator_step; JAX jits the distributed
step stage by stage) are likewise the single-device compiled steps with
the sharded solvers passed in: the solve's collectives are captured inside
the keyframe segment's graphs. That needs collectives a CUDA graph can
hold, NCCL's (``Mesh.capturable``); over gloo on the card the eager steps
run, and the compiled makers refuse.

Every rank must make the same collectives in the same order. The host
branches read only replicated values (``is_kf``, ``full_now``, the IMU
interval's count), which agree across ranks because every rank runs the
same frontend on the same images with the same draws (the RANSAC gate's
generator is seeded by the frame id); the solvers' loops are fixed-trip.
The compiled steps choose their variants from the same values (``is_kf``
and the host mirror of the state's counts), so every rank replays the same
graphs in the same order.
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace

import torch

from ..models import estimator as est
from ..models import estimator_vio as ev
from . import dist_ba, dist_vio_ba
from .mesh import Mesh


def _check_capacity(capacity: int, mesh: Mesh) -> None:
    if capacity % mesh.size:
        raise ValueError(f"capacity {capacity} not divisible by mesh size "
                         f"{mesh.size}")


def _vo_solvers(mesh: Mesh):
    return SimpleNamespace(
        solve_ba=partial(dist_ba.solve_ba_distributed, mesh),
        solve_ba_marginalized=partial(
            dist_ba.solve_ba_marginalized_distributed, mesh),
        counters=(mesh.counts,))


def _vio_solvers(mesh: Mesh):
    return SimpleNamespace(
        solve_vio_ba=partial(dist_vio_ba.solve_vio_ba_distributed, mesh),
        solve_vio_ba_marginalized=partial(
            dist_vio_ba.solve_vio_ba_marginalized_distributed, mesh),
        counters=(mesh.counts,))


def _compiled_device(mesh: Mesh, device, maker: str, eager: str):
    """The compiled step's device (default the mesh's); refuses, before
    anything touches CUDA, a mesh whose collectives a CUDA graph cannot
    hold."""
    dev = torch.device(mesh.device if device is None else device)
    if dev.type == "cuda" and not mesh.capturable:
        raise ValueError(
            f"{maker}: the mesh's {mesh.backend} collectives cannot be "
            f"captured in a CUDA graph (gloo stages each one through the "
            f"host); use {eager}(cfg, mesh), the eager step, on this mesh")
    return dev


def _warmed(step, mesh: Mesh):
    """`step`, after NCCL's communicator is made ahead of its first
    capture (Mesh.warm_up) when it runs on the card."""
    if step.device.type == "cuda":
        mesh.warm_up()
    return step


def make_distributed_estimator_step(cfg: est.EstimatorConfig, mesh: Mesh,
                                    draws=est.gumbel_draws, probe=None):
    """The VO step (state, rig, img0, img1) -> (state, FrameOutput) with
    the window BA landmark-sharded over `mesh`: every rank calls it on the
    same state and images (on its mesh device) and gets the same result.
    The landmark capacity (cfg.frontend.capacity) must divide by the mesh
    size. `draws`, `probe` as in make_estimator_step."""
    _check_capacity(cfg.frontend.capacity, mesh)
    return est.make_estimator_step(cfg, draws, probe, _vo_solvers(mesh))


def make_distributed_vio_estimator_step(vcfg: ev.VIOEstimatorConfig,
                                        mesh: Mesh, draws=est.gumbel_draws,
                                        probe=None):
    """The VIO step (state, rig, img0, img1, gyro, accel, dts, imu_mask)
    -> (state, FrameOutput) with the joint 15-dim window solve
    landmark-sharded over `mesh`; as make_distributed_estimator_step."""
    _check_capacity(vcfg.base.frontend.capacity, mesh)
    return ev.make_vio_estimator_step(vcfg, draws, probe, _vio_solvers(mesh))


def make_compiled_distributed_estimator_step(cfg: est.EstimatorConfig,
                                             mesh: Mesh,
                                             draws=est.gumbel_draws,
                                             device=None, probe=None):
    """make_distributed_estimator_step as CUDA graphs: the compiled VO step
    (models.estimator.make_compiled_estimator_step, its results and its
    one blocking read a frame) with the window BA landmark-sharded over
    `mesh`, its collectives captured in the graphs and `mesh.counts`
    carried over replays. `device`: default the mesh's; "cpu" runs the same
    segments eagerly. Raises ValueError on a mesh whose collectives cannot
    be captured (gloo) with a CUDA device, on `probe` (as the single-device
    compiled step) and on a capacity that does not divide by the mesh
    size."""
    dev = _compiled_device(mesh, device,
                           "make_compiled_distributed_estimator_step",
                           "make_distributed_estimator_step")
    _check_capacity(cfg.frontend.capacity, mesh)
    return _warmed(est.make_compiled_estimator_step(
        cfg, draws, dev, probe, _vo_solvers(mesh)), mesh)


def make_compiled_distributed_vio_estimator_step(vcfg: ev.VIOEstimatorConfig,
                                                 mesh: Mesh,
                                                 draws=est.gumbel_draws,
                                                 device=None, probe=None):
    """make_distributed_vio_estimator_step as CUDA graphs (the compiled VIO
    step, models.estimator_vio.make_compiled_vio_estimator_step, with the
    joint solve landmark-sharded over `mesh`); as
    make_compiled_distributed_estimator_step."""
    dev = _compiled_device(mesh, device,
                           "make_compiled_distributed_vio_estimator_step",
                           "make_distributed_vio_estimator_step")
    _check_capacity(vcfg.base.frontend.capacity, mesh)
    return _warmed(ev.make_compiled_vio_estimator_step(
        vcfg, draws, dev, probe, _vio_solvers(mesh)), mesh)
