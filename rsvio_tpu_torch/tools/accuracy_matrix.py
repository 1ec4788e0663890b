"""Accuracy matrix: {VO, VO+marg, VIO, VIO+marg, and the dynamic and
adaptive profiles} x the adversarial synthetic scenes (6-DoF motion,
depth structure, photometric drift, moving occluder) -> ATE RMSE and
drift table.

Port of tools/accuracy_matrix.py: the same profiles, flags, scene
geometry scaling, per-scene IMU-noise seeds, table and JSON keys. The
scenes come from rsvio_tpu_torch.data.synthetic (exact ground truth,
rendered on the device), the metrics from rsvio_tpu_torch.utils.evaluation.

Usage:
  python -m rsvio_tpu_torch.tools.accuracy_matrix           # GPU, full res
  python -m rsvio_tpu_torch.tools.accuracy_matrix --device cpu \\
      --frames 40 --width 320
  python -m rsvio_tpu_torch.tools.accuracy_matrix --scenes depth_6dof \\
      occlusion_6dof

Writes a markdown table to stdout and a JSON blob to --json (default
accuracy_matrix_torch.json).
"""

from __future__ import annotations

import argparse
import json
import sys
import zlib

import numpy as np
import torch

CONFIGS = [
    ("vo_fifo", dict(use_vio=False, use_marginalization=False)),
    ("vo_marg", dict(use_vio=False, use_marginalization=True)),
    ("vio_fifo", dict(use_vio=True, use_marginalization=False)),
    ("vio_marg", dict(use_vio=True, use_marginalization=True)),
    # Dynamic-scene profile: a heavy PnP motion prior (anchored at the
    # measured previous pose) rides through coherent moving occluders at
    # the cost of lag on clean scenes; the strict coarse-level policy keeps
    # weakly verified occluder tracks out (config/euroc_vo_dynamic.yaml).
    ("vo_dyn", dict(use_vio=False, use_marginalization=False,
                    motion_prior=20.0, coarse_level_policy="strict")),
    # Adaptive profiles: the RANSAC consensus inlier fraction drives the
    # motion-prior weight and the window solve's vision weights.
    ("vo_adapt", dict(use_vio=False, use_marginalization=False,
                      motion_prior=20.0, ransac=16, adaptive=True)),
    # vio_adapt adds the uncentred scene-flow gate and the physical bias
    # random-walk stiffness (gyro 1e5, accel 1e3).
    ("vio_adapt", dict(use_vio=True, use_marginalization=False,
                       motion_prior=20.0, ransac=16, adaptive=True,
                       dynamic_flow=0.02,
                       bias_gyro_weight=1e5, bias_accel_weight=1e3)),
]

IMU_BIASES = dict(gyro_bias=[0.003, -0.002, 0.004],
                  accel_bias=[0.02, -0.015, 0.01])
IMU_NOISE = dict(gyro_noise=1.7e-4, accel_noise=2.0e-3)


def geometry(width: int, height: int = 0, levels: int = 0, cell: int = 0,
             margin: int = 0):
    """(H, W, levels, cell, margin): the tracker geometry scales with the
    resolution (the reference tunings are for 752x480; a reduced width
    needs proportional cell / margin and fewer pyramid levels)."""
    H = height or int(width * 480 / 752)
    scale = width / 752.0
    levels = levels or max(3, min(6, int(round(np.log2(width / 12)))))
    cell = cell or max(16, int(round(50 * scale)))
    margin = margin or max(6, int(round(19 * scale)))
    return H, width, levels, cell, margin


def scene_rng(seed: int, scene: str) -> np.random.Generator:
    """Per-scene rng: a scene's IMU-noise realization does not depend on
    which other scenes run in the same invocation."""
    return np.random.default_rng(seed + zlib.crc32(scene.encode()))


def imu_kwargs(rng, noise: bool = True) -> dict:
    if not noise:
        return {}
    return dict(noise_rng=rng, **IMU_BIASES, **IMU_NOISE)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None):
    from ..cli.run import resolve_device
    from ..data import synthetic as syn
    from ..utils import evaluation as ev_util
    from ..utils.precision import pin_fp32

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--height", type=int, default=0,
                    help="0 = width * 480/752")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--configs", nargs="*", default=None)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--levels", type=int, default=0,
                    help="0 = auto from width (6 at 752, >=3)")
    ap.add_argument("--cell", type=int, default=0,
                    help="detector grid cell px; 0 = auto from width")
    ap.add_argument("--margin", type=int, default=0,
                    help="detector border margin px; 0 = auto from width")
    ap.add_argument("--imu-noise", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="inject IMU noise/bias (disable: --no-imu-noise)")
    ap.add_argument("--seed", type=int, default=7,
                    help="IMU-noise seed (per-scene rng = seed + scene hash)")
    ap.add_argument("--json", default="accuracy_matrix_torch.json")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    pin_fp32()
    H, W, levels, cell, margin = geometry(args.width, args.height,
                                          args.levels, args.cell, args.margin)
    scene_names = args.scenes or list(syn.MATRIX_SCENES)
    config_names = [c for c, _ in CONFIGS]
    if args.configs:
        config_names = [c for c in config_names if c in args.configs]
    need_imu = any(c.startswith("vio") for c in config_names)

    print(f"device={device_name(dev)} {W}x{H} frames={args.frames} "
          f"window={args.window} levels={levels} cell={cell} "
          f"margin={margin}", file=sys.stderr)

    rows = []
    for sname in scene_names:
        scene_fn, traj_fn = syn.MATRIX_SCENES[sname]
        scene = scene_fn(H=H, W=W, device=dev)
        traj = traj_fn()
        rng = scene_rng(args.seed, sname)
        kw = imu_kwargs(rng, args.imu_noise)
        print(f"[{sname}] rendering {args.frames} frames...", file=sys.stderr)
        seq = syn.generate_sequence(
            scene, traj, args.frames, fps=args.fps,
            imu_rate=200.0 if need_imu else 0.0,
            imu_kwargs=kw if need_imu else None)
        init_gyro = init_accel = None
        if need_imu:
            init_gyro, init_accel = ev_util.static_init_imu(
                traj, rng=rng, gyro_bias=kw.get("gyro_bias"),
                accel_bias=kw.get("accel_bias"),
                gyro_noise=kw.get("gyro_noise", 0.0),
                accel_noise=kw.get("accel_noise", 0.0))
        for cname, ckw in CONFIGS:
            if cname not in config_names:
                continue
            res = ev_util.run_synthetic_sequence(
                seq, scene, capacity=args.capacity, window=args.window,
                levels=levels, cell_size=cell, detect_margin=margin,
                init_gyro=init_gyro if ckw["use_vio"] else None,
                init_accel=init_accel if ckw["use_vio"] else None,
                device=dev, **ckw)
            row = dict(scene=sname, config=cname,
                       ate_rmse_m=round(res.ate_rmse, 4),
                       drift_pct=round(res.drift_pct, 3),
                       tracked=round(res.n_tracked_mean, 1),
                       ba_success=round(res.ba_success_rate, 3),
                       fps=round(res.fps, 1), skip=res.skip,
                       frames=args.frames)
            rows.append(row)
            print(f"[{sname}] {cname}: ATE {row['ate_rmse_m']:.4f} m  "
                  f"drift {row['drift_pct']:.2f}%  "
                  f"tracked {row['tracked']}  ba {row['ba_success']}  "
                  f"{row['fps']:.0f} fps", file=sys.stderr)
        del seq, scene

    print("\n| Scene | Config | ATE RMSE (m) | drift % | tracked | "
          "BA success | fps |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['scene']} | {r['config']} | {r['ate_rmse_m']:.4f} | "
              f"{r['drift_pct']:.2f} | {r['tracked']:.0f} | "
              f"{r['ba_success']:.2f} | {r['fps']:.0f} |")

    meta = dict(width=W, height=H, frames=args.frames, fps=args.fps,
                window=args.window, capacity=args.capacity,
                levels=levels, cell=cell, margin=margin,
                device=device_name(dev), rows=rows)
    with open(args.json, "w") as f:
        json.dump(meta, f, indent=1)
    print(f"\nwrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
