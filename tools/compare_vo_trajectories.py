"""Per-frame trajectories of the JAX step and the PyTorch port's step on the
same frames, beside the truth: a shipped stereo config file through each
package's load_config -> make_estimator_config, with solver keys switched
on from the command line, on the bench plane rendered through the file's
rig (rsvio_tpu_torch.data.bench_scene.render_rig, as chip_smoke.py's
configs and options phases do).

Both run on the CPU: the JAX step on its gather KLT route (its Pallas
kernel would run in interpret mode, too slow at full size), the port on
its default kernel route (the kernel's plain version on the CPU). The two
routes track with different patterns, so the trajectories differ by a few
1e-4 m on a healthy run; a divergence that both share is the
configuration's, not the port's.

Usage:
  python tools/compare_vo_trajectories.py config/euroc_vo_dynamic.yaml \\
      --solver marginalization=true pnp_cv_predict=true --frames 24
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _value(text):
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return float(text)
    except ValueError:
        return text


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--solver", nargs="*", default=[],
                    help="solver keys to set, as key=value")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    solver = dict(kv.split("=", 1) for kv in args.solver)
    solver = {k: _value(v) for k, v in solver.items()}

    import numpy as np
    import torch
    torch.set_num_threads(args.threads)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from rsvio_tpu.models import estimator as jest
    from rsvio_tpu.utils import config as jconfig
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator as test_
    from rsvio_tpu_torch.utils import config as tconfig

    cfg_t = tconfig.load_config(args.config)
    cfg_j = jconfig.load_config(args.config)
    for k, v in solver.items():
        setattr(cfg_t.solver, k, v)
        setattr(cfg_j.solver, k, v)
    cfg_j.tracker.backend = "xla"
    ecfg_t, rig_t = tconfig.make_estimator_config(cfg_t, kind="vo",
                                                  device="cpu")
    ecfg_j, rig_j = jconfig.make_estimator_config(cfg_j, kind="vo")
    tex = bench_scene.make_texture(0)
    kinds = (ecfg_t.cam_kind_l, ecfg_t.cam_kind_r)
    step_t = test_.make_estimator_step(ecfg_t)
    step_j = jest.make_estimator_step(ecfg_j)
    st_t = test_.init_state(ecfg_t, device="cpu")
    st_j = jest.init_state(ecfg_j)
    print(f"{args.config} solver {solver}: frame, keyframe (jax port), "
          f"position jax, position port, truth (m)")
    t0 = time.perf_counter()
    for k in range(args.frames):
        a, b = bench_scene.render_rig(tex, rig_t, kinds, k,
                                      ecfg_t.image_shape)
        st_t, o_t = step_t(st_t, rig_t, a, b)
        st_j, o_j = step_j(st_j, rig_j, jnp.asarray(a.numpy()),
                           jnp.asarray(b.numpy()))
        p_j = np.asarray(o_j.T_W_B)[:3, 3]
        p_t = o_t.T_W_B[:3, 3].numpy()
        truth = bench_scene.truth_position(rig_t, k).numpy()
        fmt = " ".join(["[" + ", ".join(f"{v:.4f}" for v in p) + "]"
                        for p in (p_j, p_t, truth)])
        print(f"{k:3d} {int(o_j.is_keyframe)} {int(o_t.is_keyframe)} {fmt}",
              flush=True)
    print(f"{args.frames} frames in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
