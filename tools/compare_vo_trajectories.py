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

With ``--vio RUN`` it compares the VIO steps instead, on one of
chip_smoke.py's vio runs (the same port-rendered frames, IMU stream,
bootstrap and per-frame IMU buffers; the JAX config is the port's, field
by field), and prints both runs' floor numbers (chip_smoke.vio_metrics).

Usage:
  python tools/compare_vo_trajectories.py config/euroc_vo_dynamic.yaml \\
      --solver marginalization=true pnp_cv_predict=true --frames 24
  python tools/compare_vo_trajectories.py --vio depth_6dof+vio
"""

import argparse
import json
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
    ap.add_argument("config", nargs="?")
    ap.add_argument("--vio", default=None,
                    help="a vio run of chip_smoke.py (euroc_vio+vio, "
                         "depth_6dof+vio, depth_6dof+vio+marg)")
    ap.add_argument("--solver", nargs="*", default=[],
                    help="solver keys to set, as key=value")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--port-gather", action="store_true",
                    help="run the port on the gather KLT route too, so "
                         "both steps track alike")
    ap.add_argument("--jax-pallas", action="store_true",
                    help="run JAX on its Pallas KLT kernel (interpret mode "
                         "on the CPU), the route the port's kernel follows")
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

    if args.vio:
        return compare_vio(args.vio, args.port_gather, args.jax_pallas)
    if args.config is None:
        ap.error("a config file, or --vio RUN")

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


def _to_jax(x, jax_types):
    """A port config NamedTuple as the JAX package's of the same name."""
    if hasattr(x, "_fields"):
        return jax_types[type(x).__name__](
            **{k: _to_jax(v, jax_types) for k, v in x._asdict().items()})
    return x


def compare_vio(run, port_gather=False, jax_pallas=False):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke as cs
    from rsvio_tpu.models import ba as jba
    from rsvio_tpu.models import estimator as jest
    from rsvio_tpu.models import estimator_vio as jev
    from rsvio_tpu.models import frontend as jfe
    from rsvio_tpu.models import imu as jimu
    from rsvio_tpu.models import pnp as jpnp
    from rsvio_tpu.models import vio_ba as jvb
    from rsvio_tpu.ops import klt as jklt
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator_vio as tev

    jax_types = {c.__name__: c for c in (
        jev.VIOEstimatorConfig, jest.EstimatorConfig, jfe.FrontendConfig,
        jklt.KLTConfig, jpnp.PnPConfig, jba.BAConfig, jimu.ImuParams,
        jvb.VIOBAConfig)}
    dev = torch.device("cpu")
    tex = bench_scene.make_texture(0)
    vcfg, rig, frames, traj, override = cs.vio_runs(tex, dev)[run]()
    if port_gather:
        b = vcfg.base
        vcfg = vcfg._replace(base=b._replace(frontend=b.frontend._replace(
            klt=b.frontend.klt._replace(backend="xla"))))
    # chip_smoke's floors are read over its warm-up, timed and quality
    # frames; its split frames follow them.
    n = cs.WARMUP + cs.VIO_TIMED + cs.QUAL
    frames = frames[:n]
    cfg_j = _to_jax(vcfg, jax_types)
    base = cfg_j.base
    cfg_j = cfg_j._replace(base=base._replace(frontend=base.frontend._replace(
        klt=base.frontend.klt._replace(
            backend="pallas" if jax_pallas else "xla"))))
    rig_j = jest.CameraRig(*(jnp.asarray(x.numpy()) for x in rig))
    imu, n_head, _, bufs = cs.vio_imu_inputs(traj, n, vcfg.imu_params)
    head = (imu["gyro"][:n_head], imu["accel"][:n_head])
    st_t = tev.initialize_vio_state(vcfg, *head, device="cpu")
    st_j = jev.initialize_vio_state(cfg_j, *head)
    step_t = tev.make_vio_estimator_step(vcfg)
    step_j = jev.make_vio_estimator_step(cfg_j)
    print(f"vio run {run} ({override}; JAX KLT route "
          f"{cfg_j.base.frontend.klt.backend}, port "
          f"{vcfg.base.frontend.klt.backend}): frame, keyframe (jax port), "
          f"position jax, position port, truth (m)")
    rec = {"jax": [], "port": []}
    t0 = time.perf_counter()
    for k in range(n):
        a, b = frames[k]
        st_t, o_t = step_t(st_t, rig, a, b, *bufs[k])
        st_j, o_j = step_j(st_j, rig_j, jnp.asarray(a.numpy()),
                           jnp.asarray(b.numpy()),
                           *(jnp.asarray(x) for x in bufs[k]))
        for name, o in (("jax", o_j), ("port", o_t)):
            o = jax.tree.map(np.asarray, o) if name == "jax" else \
                type(o)(*(np.asarray(x) for x in o))
            rec[name].append(np.concatenate([o.T_W_B[:3, 3], [
                o.n_tracked, o.n_alive, o.ba_success, o.pose_ok,
                o.is_keyframe]]).astype(np.float64))
        truth = traj.pose(k / cs.VIO_FPS)[:3, 3]
        fmt = " ".join(["[" + ", ".join(f"{v:.4f}" for v in p) + "]"
                        for p in (rec["jax"][-1][:3], rec["port"][-1][:3],
                                  truth)])
        print(f"{k:3d} {int(o_j.is_keyframe)} {int(o_t.is_keyframe)} {fmt}",
              flush=True)
    for name, st in (("jax", st_j), ("port", st_t)):
        m = cs.vio_metrics(np.stack(rec[name][:n]), traj,
                           np.asarray(st.vel, np.float64),
                           vcfg.base.window_size)
        m.update(bias_gyro=np.asarray(st.bg).tolist(),
                 bias_accel=np.asarray(st.ba).tolist())
        print(f"{name}: " + json.dumps(m), flush=True)
    print(f"{n} frames in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
