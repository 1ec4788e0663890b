"""Per-component timing on one device at the EuRoC shape (752x480):
dispatch of a trivial op, pyramid, detection scores, KLT tracking, PnP and
BA — to find where the frame budget goes.

Port of tools/profile_components.py, on the same random inputs. Each
component is timed compiled, as JAX's tool times jitted functions: a CUDA
graph (utils.graphs.compile_function; a call copies the inputs into the
graph's buffers and replays it); ``--eager`` times the eager calls
instead. Each line is the median over its calls, each timed on its own
(bench_solvers' ``time_calls``: CUDA events and a sync after each call on
CUDA, the host clock on the CPU). On CUDA the KLT lines run K1
(``klt_bidir``) and print its launches a call (a replay counts as one).

    python -m rsvio_tpu_torch.tools.profile_components [--device cuda|cpu]
        [--eager]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .bench_solvers import time_calls

SHAPE = (480, 752)      # EuRoC
LEVELS = 6
FEATURES = 256          # KLT features and PnP / BA landmarks
WINDOW = 10             # BA keyframes


def main(argv=None):
    from ..cli.run import resolve_device
    from ..models import ba, pnp
    from ..ops import detect, klt, pyramid
    from ..models.estimator import KERNEL_COUNTERS
    from ..ops.cuda import klt_kernel as kk
    from ..utils.graphs import compile_function
    from ..utils.precision import pin_fp32

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("--eager", action="store_true",
                    help="time the eager calls, not the compiled ones")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pin_fp32()
    f32 = dict(dtype=torch.float32, device=dev)

    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else "cpu")
    print("calls:", "eager" if args.eager
          else "compiled (utils.graphs.compile_function)")
    results = {}

    def timed(fn, *inputs, n, warmup=2):
        """Median ms of fn(*inputs), compiled unless --eager."""
        if not args.eager:
            fn = compile_function(fn, dev, KERNEL_COUNTERS)
        return time_calls(lambda: fn(*inputs), dev, n=n, warmup=warmup)

    def line(name, label, fn, inputs, n):
        ms = timed(fn, *inputs, n=n)
        results[name] = ms
        print(f"{label:<24}{ms:8.2f} ms", flush=True)

    rng = np.random.default_rng(0)
    H, W = SHAPE
    img = torch.as_tensor(rng.uniform(0, 255, (H, W)).astype(np.float32),
                          **f32)

    # 0. dispatch latency
    line("dispatch", "dispatch (trivial add):", lambda x: x + 1.0, (img,),
         20)

    # 1. pyramid
    line("pyramid", f"pyramid {LEVELS} levels:",
         lambda x: pyramid.build_pyramid(x, LEVELS), (img,), 10)
    pyr = pyramid.build_pyramid(img, LEVELS)

    # 2. detection
    line("fast_score", "fast_score:", detect.fast_score, (img,), 10)
    line("shi_tomasi_score", "shi_tomasi_score:", detect.shi_tomasi_score,
         (img,), 10)

    # 3. KLT tracking (bidirectional, all levels)
    N = FEATURES
    pts = torch.as_tensor(rng.uniform([30, 30], [W - 30, H - 30],
                                      size=(N, 2)).astype(np.float32), **f32)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    for name, its in (("klt_bidir_20", 20), ("klt_bidir_8", 8)):
        cfg = klt.KLTConfig(levels=LEVELS, max_iterations=its)
        before = kk.klt_bidir.launches
        ms = timed(lambda *a, cfg=cfg: klt.track_points_bidirectional(
            *a, cfg), pyr, pyr, pts, alive, n=5)
        per = (kk.klt_bidir.launches - before) / 7    # 5 timed + 2 warm-up
        results[name] = ms
        results[name + "_launches"] = per
        label = (f"KLT bidir {N} feats:" if its == 20 else
                 f"KLT bidir ({its} iters):")
        print(f"{label:<24}{ms:8.2f} ms  (K1 launches a call: {per:g})",
              flush=True)

    # 4. PnP
    L = N
    lms = torch.as_tensor(np.stack([rng.uniform(-2, 2, L),
                                    rng.uniform(-2, 2, L),
                                    rng.uniform(3, 8, L)], 1)
                          .astype(np.float32), **f32)
    obs = lms[:, :2] / lms[:, 2:3]
    obs2 = torch.stack([obs, obs])
    mask = torch.ones((2, L), dtype=torch.bool, device=dev)
    T_C_B = torch.eye(4, **f32).repeat(2, 1, 1)
    T_C_B[1, 0, 3] = -0.11
    T0 = torch.eye(4, **f32)
    line("pnp", f"PnP {L} lms:", pnp.solve_pnp,
         (T0, T_C_B, lms, obs2, mask), 5)

    # 5. BA (window x landmarks)
    WKF = WINDOW
    poses = torch.eye(4, **f32).expand(WKF, 4, 4).contiguous()
    obs_w = obs2[None].expand(WKF, 2, L, 2).contiguous()
    mask_w = torch.ones((WKF, 2, L), dtype=torch.bool, device=dev)
    lm_valid = torch.ones(L, dtype=torch.bool, device=dev)
    line("ba", f"BA {WKF}x{L}:", ba.solve_ba,
         (poses, T_C_B, lms, obs_w, mask_w, lm_valid), 3)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
