"""Evaluate ATE RMSE between an estimated trajectory and ground truth.

Port of tools/evaluate_ate.py over rsvio_tpu_torch.utils.trajectory (host
numpy; no device).

Usage:
  python -m rsvio_tpu_torch.tools.evaluate_ate <estimate.tum> <groundtruth>
      [--max-dt S] [--scale] [--gnss]

Both files are TUM format (`t x y z qx qy qz qw`); EuRoC
state_groundtruth_estimate0/data.csv also parses (comma-separated, ns
timestamps are auto-detected by magnitude). --gnss treats the ground-truth
file as 4Seasons GNSSPoses.txt. --scale aligns with Sim(3) (monocular-style)
instead of SE(3).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from ..utils.trajectory import associate, ate_rmse, gnss_to_tum, load_tum


def load_any(path: str):
    """TUM or EuRoC-CSV trajectory -> (ts_s, pos, quat)."""
    ts, pos, quat = load_tum(path)
    if len(ts) and ts.max() > 1e14:   # ns timestamps -> seconds
        ts = ts * 1e-9
    return ts, pos, quat


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("estimate")
    ap.add_argument("groundtruth")
    ap.add_argument("--max-dt", type=float, default=0.02,
                    help="association window in seconds")
    ap.add_argument("--scale", action="store_true",
                    help="Sim(3) alignment (estimate scale)")
    ap.add_argument("--gnss", action="store_true",
                    help="ground truth is 4Seasons GNSSPoses.txt")
    args = ap.parse_args(argv)

    gt_path = args.groundtruth
    tmp = None
    if args.gnss:
        fd, tmp = tempfile.mkstemp(suffix=".tum")
        os.close(fd)
        gnss_to_tum(gt_path, tmp)
        gt_path = tmp
    try:
        ts_e, pos_e, _ = load_any(args.estimate)
        ts_g, pos_g, _ = load_any(gt_path)
    finally:
        if tmp is not None:
            os.unlink(tmp)
    ia, ib = associate(ts_e, ts_g, args.max_dt)
    if len(ia) < 3:
        print(f"ERROR: only {len(ia)} associations (est {len(ts_e)}, "
              f"gt {len(ts_g)}); check timestamps / --max-dt")
        return 1
    rmse, aligned = ate_rmse(pos_e[ia], pos_g[ib], with_scale=args.scale)
    err = np.linalg.norm(aligned - pos_g[ib], axis=1)
    print(f"associations: {len(ia)}")
    print(f"ate_rmse_m:   {rmse:.6f}")
    print(f"ate_mean_m:   {err.mean():.6f}")
    print(f"ate_median_m: {np.median(err):.6f}")
    print(f"ate_max_m:    {err.max():.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
