"""Run the distributed layer on n local ranks: ``run_ranks`` (spawned
processes over a file store) and ``dryrun_multichip``.

Port of ``dryrun_multichip`` in __graft_entry__.py: at that function's tiny
sizes, the four sharded window solvers and both distributed steps (until
a sharded solve fires) on an n-rank mesh, each held to the single-device
result, with the lines JAX prints. Where the mesh's collectives can be
captured (NCCL), the compiled distributed steps too, held to the eager
distributed steps within 1e-5 m.

    python -m rsvio_tpu_torch.parallel.dryrun 2 [--backend gloo|nccl]
        [--devices cuda|cpu]

NCCL runs one rank per card; gloo puts several ranks on one card or runs
on the CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh
from .multihost import initialize_distributed


def _rank_main(fn, rank, world_size, init_method, backend, devices, threads,
               args, out_path):
    if threads:
        torch.set_num_threads(threads)
    initialize_distributed(init_method, world_size, rank, backend)
    try:
        mesh = make_mesh(world_size, devices, backend)
        result = fn(mesh, *args)
        np.savez(out_path, **(result or {}))
    except Exception:
        # Exit at once, without tearing the group down: the other ranks
        # may wait in a collective this rank will never join (run_ranks
        # then ends them), and a teardown could wait on them.
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, backend=None, devices=None,
              timeout: float = 120.0, workdir=None, threads=None):
    """Run fn(mesh, *args) on `world_size` spawned ranks over a file store
    in `workdir` (a fresh temporary directory by default) and return each
    rank's result, a dict of numpy arrays (fn returns a dict of arrays or
    numbers, or None). fn must be importable by the spawned processes.
    threads: torch's CPU threads a rank (default torch's own).
    Raises when a rank fails (the others are terminated at once) or when
    the ranks have not finished within `timeout` seconds."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="rsvio_ranks_") if own else workdir
    ctx = torch.multiprocessing.get_context("spawn")
    init_method = "file://" + os.path.join(os.path.abspath(workdir), "store")
    outs = [os.path.join(workdir, f"rank{r}.npz") for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, init_method, backend,
                               devices, threads, args, outs[r]))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.exitcode is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode]
            if failed:
                raise RuntimeError(
                    f"run_ranks: rank(s) {failed} failed (exit codes "
                    f"{[p.exitcode for p in procs]})")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"run_ranks: {world_size} ranks not done in {timeout} s")
            time.sleep(0.02)
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"run_ranks: exit codes {codes}")
        results = []
        for path in outs:
            with np.load(path) as z:
                results.append({k: z[k] for k in z.files})
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


# ----------------------------------------------------------------- inputs

def window_problem(W: int, L: int, seed: int = 0, device="cuda",
                   dtype=torch.float32):
    """dryrun_multichip's synthetic window: W keyframes 0.2 m apart with a
    small random rotation each, L landmarks in front of them, their
    noise-free stereo observations and landmarks perturbed by 0.05 m.
    Returns (T_W_B, T_C_B, landmarks, obs, obs_mask, lm_valid)."""
    from ..ops import lie
    rng = np.random.default_rng(seed)
    T_C_B = np.stack([np.eye(4), np.eye(4)])
    T_C_B[1, 0, 3] = -0.11
    T_W_B = np.stack([np.eye(4)] * W)
    for i in range(W):
        T_W_B[i, :3, :3] = lie.so3_exp(torch.from_numpy(
            rng.normal(size=3) * 0.02)).numpy()
        T_W_B[i, 0, 3] = 0.2 * i
    p_W = np.stack([rng.uniform(-2, 3, L), rng.uniform(-2, 2, L),
                    rng.uniform(3, 8, L)], axis=1)
    obs = np.zeros((W, 2, L, 2))
    mask = np.zeros((W, 2, L), bool)
    for i in range(W):
        T_B_W = np.linalg.inv(T_W_B[i])
        for c in range(2):
            pC = (T_C_B[c, :3, :3] @ (T_B_W[:3, :3] @ p_W.T
                                      + T_B_W[:3, 3:4]) + T_C_B[c, :3, 3:4]).T
            ok = pC[:, 2] > 0.5
            obs[i, c, ok] = pC[ok, :2] / pC[ok, 2:3]
            mask[i, c] = ok
    lms = p_W + rng.normal(size=p_W.shape) * 0.05

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)
    return (t(T_W_B), t(T_C_B), t(lms), t(obs),
            torch.as_tensor(mask, device=device),
            torch.ones(L, dtype=torch.bool, device=device))


def hover_preint(W: int, device="cuda", dtype=torch.float32):
    """dryrun_multichip's IMU intervals: W-1 of 10 samples at 0.01 s, no
    rotation, specific force = gravity. Returns (Preintegrated, valid)."""
    from ..models import imu as imu_mod
    S = 10
    z = torch.zeros(3, dtype=dtype, device=device)
    accel = torch.zeros((S, 3), dtype=dtype, device=device)
    accel[:, 2] = imu_mod.GRAVITY
    pre = imu_mod.preintegrate(torch.zeros((S, 3), dtype=dtype,
                                           device=device), accel,
                               torch.full((S,), 0.01, dtype=dtype,
                                          device=device),
                               torch.ones(S, dtype=torch.bool, device=device),
                               z, z)
    pre = imu_mod.Preintegrated(*(x[None].expand(W - 1, *x.shape)
                                  .contiguous() for x in pre))
    return pre, torch.ones(W - 1, dtype=torch.bool, device=device)


def vio_window_problem(W: int, L: int, seed: int = 0, device="cuda",
                       dtype=torch.float32, kf_dt: float = 0.25):
    """tests/test_vio_ba.py's make_vio_problem at W keyframes and L
    landmarks: constant velocity (0.4, 0.1, 0) m/s without rotation,
    keyframes kf_dt apart, a perfect 200 Hz IMU (preintegrated with the
    port), stereo observations, and the initial states perturbed (poses
    0.01 rad / 0.02 m, velocity 0.05 m/s, landmarks 0.05 m). Returns
    (VIOState, T_C_B, landmarks, obs, obs_mask, lm_valid, Preintegrated,
    preint_valid)."""
    from ..models import imu as imu_mod
    from ..models import vio_ba
    from ..ops import lie
    rng = np.random.default_rng(seed)
    v = np.array([0.4, 0.1, 0.0])
    T_gt = np.stack([np.eye(4)] * W)
    T_gt[:, :3, 3] = v * kf_dt * np.arange(W)[:, None]
    p_W = np.stack([rng.uniform(-2, 3, L), rng.uniform(-2, 2, L),
                    rng.uniform(3, 8, L)], axis=1)
    _, T_C_B, _, obs, mask, lm_valid = window_problem(1, 1, device=device,
                                                      dtype=dtype)
    T_C_B_np = T_C_B.double().cpu().numpy()
    obs = np.zeros((W, 2, L, 2))
    mask = np.zeros((W, 2, L), bool)
    for i in range(W):
        T_B_W = np.linalg.inv(T_gt[i])
        for c in range(2):
            pC = (T_C_B_np[c, :3, :3] @ (T_B_W[:3, :3] @ p_W.T
                                         + T_B_W[:3, 3:4])
                  + T_C_B_np[c, :3, 3:4]).T
            ok = pC[:, 2] > 0.5
            obs[i, c, ok] = pC[ok, :2] / pC[ok, 2:3]
            mask[i, c] = ok
    T0 = T_gt.copy()
    for i in range(1, W):
        T0[i, :3, :3] = lie.so3_exp(torch.from_numpy(
            rng.normal(size=3) * 0.01)).numpy()
        T0[i, :3, 3] += rng.normal(size=3) * 0.02
    vel = v + rng.normal(size=(W, 3)) * 0.05
    lms = p_W + rng.normal(size=p_W.shape) * 0.05

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)
    S = int(round(kf_dt * 200.0))
    accel = torch.zeros((S, 3), dtype=dtype, device=device)
    accel[:, 2] = imu_mod.GRAVITY
    z = torch.zeros(3, dtype=dtype, device=device)
    pre = imu_mod.preintegrate(
        torch.zeros((S, 3), dtype=dtype, device=device), accel,
        torch.full((S,), 1.0 / 200.0, dtype=dtype, device=device),
        torch.ones(S, dtype=torch.bool, device=device), z, z)
    pre = imu_mod.Preintegrated(*(x[None].expand(W - 1, *x.shape)
                                  .contiguous() for x in pre))
    zW = torch.zeros((W, 3), dtype=dtype, device=device)
    return (vio_ba.VIOState(T_W_B=t(T0), vel=t(vel), bg=zW, ba=zW), T_C_B,
            t(lms), t(obs), torch.as_tensor(mask, device=device),
            torch.ones(L, dtype=torch.bool, device=device), pre,
            torch.ones(W - 1, dtype=torch.bool, device=device))


def tiny_setup(device="cuda", capacity_multiple: int = 1):
    """__graft_entry__._tiny_setup: the 96x128 VO config (32 slots, 3
    levels, window 4; the capacity rounded up to a multiple of
    `capacity_multiple`), its rig and state, and the smooth texture."""
    from ..models import estimator as est
    from ..models.frontend import FrontendConfig
    from ..ops import cameras
    from ..ops.klt import KLTConfig
    H, W = 96, 128
    cap = -(-32 // capacity_multiple) * capacity_multiple
    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=cap, cell_size=24, detect_margin=10,
                                klt=KLTConfig(levels=3, max_iterations=8)),
        window_size=4, image_shape=(H, W))
    params = cameras.pack_params(cameras.PINHOLE_RADTAN,
                                 [100.0, 100.0, W / 2, H / 2], [0, 0, 0, 0],
                                 device=device)
    T_r = torch.eye(4, device=device)
    T_r[0, 3] = 0.11
    rig = est.make_rig(params, params, torch.eye(4, device=device), T_r)
    rng = np.random.default_rng(0)
    tex = (np.kron(rng.uniform(0, 1, (H // 8, W // 8)), np.ones((8, 8))) * 140
           + np.kron(rng.uniform(0, 1, (H // 4, W // 4)), np.ones((4, 4)))
           * 70 + 40).astype(np.float32)
    return cfg, rig, est.init_state(cfg, device=device), \
        torch.from_numpy(tex).to(device)


# ----------------------------------------------------------------- dryrun

def _max_diff(a, b):
    return float((a - b).abs().max())


def _dryrun_rank(mesh):
    from ..models import ba, vio_ba
    from ..models import estimator as est
    from ..models import estimator_vio as ev
    from ..models import imu as imu_mod
    from ..models.marginalization import empty_prior
    from . import dist_ba, dist_vio_ba
    from .dist_estimator import (
        make_compiled_distributed_estimator_step,
        make_compiled_distributed_vio_estimator_step,
        make_distributed_estimator_step, make_distributed_vio_estimator_step)

    n, dev = mesh.size, mesh.device

    def say(msg):
        if mesh.rank == 0:
            print(f"dryrun_multichip({n}): {msg}", flush=True)

    def check(cond, msg):
        if not cond:
            raise RuntimeError(f"dryrun_multichip({n}): {msg}")

    W_KF = 4
    prob = window_problem(W_KF, 8 * n, device=dev)
    T_W_B = prob[0]

    cfg5 = ba.BAConfig(max_iterations=5)
    res = dist_ba.solve_ba_distributed(mesh, *prob, cfg5)
    loc = ba.solve_ba(*prob, cfg5)
    check(bool(res.success), f"distributed BA failed: status "
          f"{int(res.status)}")
    m = res.metrics
    check(m.shape[1] == ba.N_METRIC_COLS
          and bool((m[:int(res.iterations), 0] > 0).all()),
          "distributed observer metrics missing")
    dT = _max_diff(res.T_W_B, loc.T_W_B)
    check(dT < 1e-3, f"distributed BA diverges from local: max|dT|={dT}")
    say(f"distributed BA ok, cost {float(res.initial_cost):.4g} -> "
        f"{float(res.final_cost):.4g}, parity max|dT|={dT:.2e}")

    cfg4 = ba.BAConfig(max_iterations=4)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    bres, bprior = dist_ba.solve_ba_marginalized_distributed(
        mesh, *prob, empty_prior(W_KF, 6, device=dev), yes, cfg4)
    lres, lprior = ba.solve_ba_marginalized(
        *prob, empty_prior(W_KF, 6, device=dev), yes, cfg4)
    check(bool(bres.success), f"distributed marginalized BA failed: status "
          f"{int(bres.status)}")
    check(bool(bprior.valid), "BA marginalization prior not produced")
    dT = _max_diff(bres.T_W_B, lres.T_W_B)
    dH = _max_diff(bprior.H, lprior.H) / max(1.0, float(lprior.H.abs().max()))
    check(dT < 1e-3 and dH < 5e-3, f"distributed marginalized BA diverges "
          f"from local: max|dT|={dT} max|dH|/scale={dH}")
    say(f"distributed marginalized BA ok, prior live, parity "
        f"max|dT|={dT:.2e} max|dH|/scale={dH:.2e}")

    pre, pre_valid = hover_preint(W_KF, device=dev)
    z3 = torch.zeros((W_KF, 3), device=dev)
    st0 = vio_ba.VIOState(T_W_B=T_W_B, vel=z3, bg=z3, ba=z3)
    vargs = (st0, *prob[1:], pre, pre_valid)
    vcfg = vio_ba.VIOBAConfig(max_iterations=4)
    vres = dist_vio_ba.solve_vio_ba_distributed(mesh, *vargs, vcfg)
    vloc = vio_ba.solve_vio_ba(*vargs, vcfg)
    check(bool(vres.success), f"distributed VIO BA failed: status "
          f"{int(vres.status)}")
    dT = _max_diff(vres.state.T_W_B, vloc.state.T_W_B)
    check(dT < 1e-3, f"distributed VIO BA diverges from local: max|dT|={dT}")
    say(f"distributed VIO BA ok, cost {float(vres.initial_cost):.4g} -> "
        f"{float(vres.final_cost):.4g}, parity max|dT|={dT:.2e}")

    mres, mprior = dist_vio_ba.solve_vio_ba_marginalized_distributed(
        mesh, *vargs, empty_prior(W_KF, 15, device=dev), yes, vcfg)
    mloc, mprior_l = vio_ba.solve_vio_ba_marginalized(
        *vargs, empty_prior(W_KF, 15, device=dev), yes, vcfg)
    check(bool(mres.success), f"distributed marginalized VIO BA failed: "
          f"status {int(mres.status)}")
    check(bool(mprior.valid), "marginalization prior not produced")
    dT = _max_diff(mres.state.T_W_B, mloc.state.T_W_B)
    dH = _max_diff(mprior.H, mprior_l.H) / max(
        1.0, float(mprior_l.H.abs().max()))
    check(dT < 1e-3 and dH < 5e-3, f"distributed marginalized VIO BA "
          f"diverges from local: max|dT|={dT} max|dH|/scale={dH}")
    say(f"distributed marginalized VIO BA ok, prior live, parity "
        f"max|dT|={dT:.2e} max|dH|/scale={dH:.2e}")

    # The full steps on the rolling-image stereo sequence (left image
    # rolled k px, right k+4 px: a fronto scene translating at constant
    # disparity), beside the single-device steps, until a sharded solve.
    cfg, rig, _, img = tiny_setup(dev, capacity_multiple=n)
    vcfg_full = ev.VIOEstimatorConfig(base=cfg, imu_buf=8, interval_buf=64)
    S = 8
    accel = np.zeros((S, 3), np.float32)
    accel[:, 2] = imu_mod.GRAVITY
    imu = (np.zeros((S, 3), np.float32), accel,
           np.full(S, 0.005, np.float32), np.ones(S, bool))
    runs = (("estimator", make_distributed_estimator_step(cfg, mesh),
             est.make_estimator_step(cfg), est.init_state(cfg, device=dev),
             ()),
            ("VIO estimator", make_distributed_vio_estimator_step(
                vcfg_full, mesh), ev.make_vio_estimator_step(vcfg_full),
             ev.init_vio_state(vcfg_full, device=dev), imu))
    for name, dstep, lstep, state, imu_args in runs:
        s_d = s_l = state
        saw, gap = False, 0.0
        for k in range(6):
            imgs = (torch.roll(img, -k, dims=1),
                    torch.roll(img, -(k + 4), dims=1))
            s_d, o_d = dstep(s_d, rig, *imgs, *imu_args)
            s_l, o_l = lstep(s_l, rig, *imgs, *imu_args)
            gap = max(gap, _max_diff(o_d.T_W_B, o_l.T_W_B))
            saw = saw or bool(o_d.ba_success)
            if saw and k >= 3:
                break
        check(saw, f"distributed {name} never reached a sharded solve")
        check(gap < 5e-3, f"distributed {name} diverges from the "
              f"single-device step: max|dT|={gap}")
        say(f"full distributed {name} step ok (sharded window solve inside "
            f"the frame loop), max|dT| vs single-device {gap:.2e}")
    if not mesh.capturable:
        return {"counts": np.array([mesh.counts[k]
                                    for k in sorted(mesh.counts)])}
    # The compiled distributed steps (CUDA graphs, the solve's collectives
    # captured) against the eager distributed steps on the same frames.
    for name, compiled, eager, state, imu_args in (
            ("estimator", make_compiled_distributed_estimator_step(cfg, mesh),
             make_distributed_estimator_step(cfg, mesh),
             est.init_state(cfg, device=dev), ()),
            ("VIO estimator", make_compiled_distributed_vio_estimator_step(
                vcfg_full, mesh), make_distributed_vio_estimator_step(
                    vcfg_full, mesh),
             ev.init_vio_state(vcfg_full, device=dev), imu)):
        s_c = s_e = state
        saw, gap = False, 0.0
        for k in range(6):
            imgs = (torch.roll(img, -k, dims=1),
                    torch.roll(img, -(k + 4), dims=1))
            s_c, o_c = compiled(s_c, rig, *imgs, *imu_args)
            s_e, o_e = eager(s_e, rig, *imgs, *imu_args)
            gap = max(gap, _max_diff(o_c.T_W_B, o_e.T_W_B))
            saw = saw or bool(o_c.ba_success)
        check(saw, f"compiled distributed {name} never reached a sharded "
              f"solve")
        check(gap <= 1e-5, f"compiled distributed {name} diverges from the "
              f"eager distributed step: max|dT|={gap}")
        say(f"compiled distributed {name} step ok ({len(compiled.graphs.graphs)}"
            f" graphs, {compiled.graphs.replays} replays), max|dT| vs eager "
            f"{gap:.2e}")
    return {"counts": np.array([mesh.counts[k] for k in sorted(mesh.counts)])}


def dryrun_multichip(n_devices: int, backend=None, devices=None,
                     threads=None):
    """Run the dryrun on `n_devices` spawned ranks (see the module
    docstring; `threads` as in run_ranks); raises when any check fails on
    any rank or the ranks take more than 300 s."""
    return run_ranks(_dryrun_rank, n_devices, backend=backend,
                     devices=devices, timeout=300.0, threads=threads)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--backend", choices=("nccl", "gloo"))
    ap.add_argument("--devices", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    dryrun_multichip(a.n_devices, a.backend, a.devices)


if __name__ == "__main__":
    main()
