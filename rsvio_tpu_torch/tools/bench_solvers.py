"""Window-solver timing on one device: plain BA, marginalized BA, VIO BA
and marginalized VIO BA at production shapes (W=10, L=256).

Port of tools/bench_solvers.py: the same problem from the same numpy
draws. Each solver runs its full LM iteration budget (cost and parameter
tolerances 0), so the numbers are iteration cost, not convergence speed.
The solvers are timed compiled, as JAX's tool times its jitted solvers:
each a CUDA graph (utils.graphs.compile_function; the call copies the
inputs into the graph's buffers and replays it); ``--eager`` times the
eager calls instead, every kernel launched from the host. Each call is
timed on its own: on CUDA between events recorded before and after it,
synchronized after each call; on the CPU by the host clock. The line
gives the median over -n calls after a warm-up (which captures the graph).

    python -m rsvio_tpu_torch.tools.bench_solvers [--device cuda|cpu] [-n N]
        [--lm L] [--window W] [--eager]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

W_KF = 10
N_LM = 256
KF_DT = 0.25
IMU_HZ = 200.0


def make_problem(seed=0, window=W_KF, n_lm=N_LM, device="cuda"):
    """A W-keyframe window at constant velocity (0.4, 0.1, 0) m/s with a
    perfect hovering IMU between keyframes, L landmarks seen in stereo, and
    the initial poses, velocities and landmarks perturbed. Returns
    (VIOState, T_C_B, landmarks, obs, obs_mask, lm_valid, Preintegrated,
    preint_valid), float32 on `device`."""
    from ..models import imu, vio_ba
    from ..ops import lie

    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    g = np.array([0.0, 0.0, -imu.GRAVITY])
    v_const = np.array([0.4, 0.1, 0.0])

    T_C_B = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    T_C_B[1, 0, 3] = -0.11

    T_gt = np.stack([np.eye(4, dtype=np.float32)] * window)
    T_gt[:, :3, 3] = v_const * KF_DT * np.arange(window)[:, None]
    v_gt = np.tile(v_const, (window, 1)).astype(np.float32)

    n_s = int(KF_DT * IMU_HZ)
    zb = torch.zeros(3, **f32)
    pre = imu.preintegrate(
        torch.zeros((n_s, 3), **f32),
        torch.as_tensor(np.tile((-g).astype(np.float32), (n_s, 1)), **f32),
        torch.full((n_s,), 1.0 / IMU_HZ, **f32),
        torch.ones(n_s, dtype=torch.bool, device=dev), zb, zb)
    pre = imu.Preintegrated(*(x[None].expand(window - 1, *x.shape)
                              .contiguous() for x in pre))
    pre_valid = torch.ones(window - 1, dtype=torch.bool, device=dev)

    p_gt = np.stack([rng.uniform(-2, 3, n_lm), rng.uniform(-2, 2, n_lm),
                     rng.uniform(3, 8, n_lm)], axis=1).astype(np.float32)
    obs = np.zeros((window, 2, n_lm, 2), np.float32)
    mask = np.zeros((window, 2, n_lm), bool)
    for i in range(window):
        T_B_W = lie.se3_inverse(torch.from_numpy(T_gt[i])).numpy()
        for c in range(2):
            Tcb = T_C_B[c]
            pC = (Tcb[:3, :3] @ (T_B_W[:3, :3] @ p_gt.T + T_B_W[:3, 3:4])
                  + Tcb[:3, 3:4]).T
            ok = pC[:, 2] > 0.5
            obs[i, c, ok] = pC[ok, :2] / pC[ok, 2:3]
            mask[i, c] = ok

    poses_i = [T_gt[0]]
    for i in range(1, window):
        dR = lie.so3_exp(torch.as_tensor(rng.normal(size=3) * 0.01,
                                         dtype=torch.float32)).numpy()
        T = T_gt[i].copy()
        T[:3, :3] = T[:3, :3] @ dR
        T[:3, 3] += rng.normal(size=3) * 0.02
        poses_i.append(T)
    state0 = vio_ba.VIOState(
        T_W_B=torch.as_tensor(np.stack(poses_i), **f32),
        vel=torch.as_tensor(v_gt, **f32)
        + torch.as_tensor(rng.normal(size=(window, 3)) * 0.05, **f32),
        bg=torch.zeros((window, 3), **f32),
        ba=torch.zeros((window, 3), **f32))
    lms0 = torch.as_tensor(p_gt + rng.normal(size=p_gt.shape) * 0.05, **f32)
    return (state0, torch.as_tensor(T_C_B, **f32), lms0,
            torch.as_tensor(obs, **f32),
            torch.as_tensor(mask, device=dev),
            torch.ones(n_lm, dtype=torch.bool, device=dev), pre, pre_valid)


def time_calls(fn, dev, n=20, warmup=3):
    """Median ms of n calls of fn, each timed on its own (CUDA events and a
    sync after each call on CUDA, the host clock on the CPU)."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    times = []
    for _ in range(n):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None):
    from ..cli.run import resolve_device
    from ..models import ba, vio_ba
    from ..models.marginalization import empty_prior
    from ..utils.graphs import compile_function
    from ..utils.precision import pin_fp32

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("-n", type=int, default=20)
    ap.add_argument("--lm", type=int, default=N_LM, help="landmark slots")
    ap.add_argument("--window", type=int, default=W_KF,
                    help="keyframe window")
    ap.add_argument("--eager", action="store_true",
                    help="time the eager calls, not the compiled ones")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pin_fp32()
    W, L = args.window, args.lm

    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else "cpu")
    print("calls:", "eager" if args.eager
          else "compiled (utils.graphs.compile_function)")
    (state0, T_C_B, lms0, obs, mask, lm_valid, pre,
     pre_valid) = make_problem(window=W, n_lm=L, device=dev)

    # Full-trip LM (no early convergence exit) -> per-iteration cost.
    cfg_ba = ba.BAConfig(cost_tol=0.0, param_tol=0.0)
    cfg_vio = vio_ba.VIOBAConfig(cost_tol=0.0, param_tol=0.0)
    evict = torch.ones((), dtype=torch.bool, device=dev)
    prior6 = empty_prior(W, 6, device=dev)
    prior15 = empty_prior(W, 15, device=dev)
    vo = (state0.T_W_B, T_C_B, lms0, obs, mask, lm_valid)
    vio = (state0, T_C_B, lms0, obs, mask, lm_valid, pre, pre_valid)
    runs = [
        ("BA", cfg_ba.max_iterations,
         lambda *a: ba.solve_ba(*a, cfg_ba), vo),
        ("BA+marg", cfg_ba.max_iterations,
         lambda *a: ba.solve_ba_marginalized(*a, cfg_ba),
         vo + (prior6, evict)),
        ("VIO BA", cfg_vio.max_iterations,
         lambda *a: vio_ba.solve_vio_ba(*a, cfg_vio), vio),
        ("VIO BA+marg", cfg_vio.max_iterations,
         lambda *a: vio_ba.solve_vio_ba_marginalized(*a, cfg_vio),
         vio + (prior15, evict)),
    ]
    results = {}
    for name, its, solve, inputs in runs:
        if not args.eager:
            solve = compile_function(solve, dev)
        ms = time_calls(lambda: solve(*inputs), dev, n=args.n)
        results[name] = ms
        label = f"{name} {W}x{L} ({its} it):"
        print(f"{label:<29}{ms:8.2f} ms", flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
