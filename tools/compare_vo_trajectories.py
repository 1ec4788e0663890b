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

With ``--matrix`` it runs the accuracy matrix's scenes and profiles
through both evaluation harnesses (rsvio_tpu.utils.evaluation and
rsvio_tpu_torch.utils.evaluation) on the same frames and IMU (the JAX
package's generate_sequence, the matrix's seeds and geometry at --width),
both on the gather KLT route by default (``--route kernel``: both on the
kernel route, JAX's Pallas kernel in interpret mode), with JAX's RANSAC
draws given to the port, and prints each row's ATE and drift beside each
other and the largest position gap. ``--geometry small`` runs the
harness tests' small geometry instead (tests/test_torch_evaluation.py:
120x188, capacity 96, window 5, 3 levels, 10 Hz, its IMU seed).

``--precision f64`` runs both sides in double (the port's harness with
``dtype=torch.float64``; the JAX side under x64 with its harness's rig,
state, frames and IMU cast to float64 — its own harness builds them in
float32 — as a ``precision: f64`` config does). ``--save PATH`` writes each
row's positions to a JSON file; ``--against PATH`` reads such a file of the
other precision and prints, per row, each package's gap to its own run
there. ``--dump-gate FRAME PATH`` writes the port's RANSAC gate inputs of
that frame to an .npz file (tests/data/ holds one). ``--trace`` records both
steps' per-frame outputs and prints, per
row, the first frame where a count, a flag or the pose (by > 1e-9 m)
differs; where the RANSAC gate ran on that frame, it also runs both
packages' gates on the port's inputs of that frame and prints each one's
inlier count and age-weighted vote (by math.fsum, free of rounding: the
quantity the gate's argmax compares).

Usage:
  python tools/compare_vo_trajectories.py config/euroc_vo_dynamic.yaml \\
      --solver marginalization=true pnp_cv_predict=true --frames 24
  python tools/compare_vo_trajectories.py --vio depth_6dof+vio
  python tools/compare_vo_trajectories.py --matrix --width 320 --frames 40
  python tools/compare_vo_trajectories.py --matrix --geometry small \
      --frames 18 --scenes depth_6dof --configs vio_fifo --precision f64 \
      --save f64.json
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
    ap.add_argument("--matrix", action="store_true",
                    help="the accuracy matrix through both harnesses")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--configs", nargs="*", default=None)
    ap.add_argument("--route", choices=("gather", "kernel"),
                    default="gather")
    ap.add_argument("--geometry", choices=("matrix", "small"),
                    default="matrix")
    ap.add_argument("--precision", choices=("f32", "f64"), default="f32",
                    help="--matrix: run both packages in this precision")
    ap.add_argument("--save", default=None,
                    help="--matrix: write each row's positions here (JSON)")
    ap.add_argument("--against", default=None,
                    help="--matrix: a --save file of the other precision")
    ap.add_argument("--trace", action="store_true",
                    help="--matrix: the first frame where the steps part")
    ap.add_argument("--dump-gate", nargs=2, metavar=("FRAME", "PATH"),
                    default=None,
                    help="--matrix: write the port's RANSAC gate inputs of "
                         "frame FRAME (last row run) to PATH (.npz)")
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
    if args.matrix:
        if args.precision == "f64":
            _jax_harness_f64()
        rows = compare_matrix(args.width, args.frames, args.scenes,
                              args.configs, args.route, args.geometry,
                              args.precision, args.against,
                              args.trace or args.dump_gate is not None,
                              args.dump_gate)
        if args.save:
            with open(args.save, "w") as f:
                json.dump({"precision": args.precision, "rows": rows}, f)
        return 0
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


# The harness tests' small geometry (tests/test_torch_evaluation.py).
SMALL = dict(H=120, W=188, fps=10.0, seed=11, capacity=96, window=5,
             levels=3, cell_size=24, detect_margin=10,
             translation_threshold=0.03, rotation_threshold=0.03)


def _jax_harness_f64():
    """Turn on x64 and make the JAX harness build its rig, states and
    inputs in float64 (it builds them in float32 itself): the estimator
    modules' names that rsvio_tpu.utils.evaluation calls are rebound for
    this process."""
    import functools
    import inspect

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rsvio_tpu.models import estimator as jest
    from rsvio_tpu.models import estimator_vio as jev
    from rsvio_tpu.models import pnp as jpnp

    f64 = jnp.float64

    def cast(x):
        x = jnp.asarray(x)
        return x.astype(f64) if jnp.issubdtype(x.dtype, jnp.floating) else x

    def steps(make):
        @functools.wraps(make)
        def wrapped(*a, **k):
            step = make(*a, **k)
            return lambda state, rig, *xs: step(state, rig,
                                                *(cast(x) for x in xs))
        return wrapped

    def double(fn):
        """fn with its dtype parameter defaulting to float64."""
        n = list(inspect.signature(fn).parameters).index("dtype")

        @functools.wraps(fn)
        def wrapped(*a, **k):
            if len(a) <= n:
                k.setdefault("dtype", f64)
            return fn(*a, **k)
        return wrapped

    make_rig = jest.make_rig
    jest.make_rig = lambda *a: jax.tree.map(cast, make_rig(*a))
    jest.init_state = double(jest.init_state)
    jest.make_estimator_step = steps(jest.make_estimator_step)
    jev.init_vio_state = double(jev.init_vio_state)
    jev.initialize_vio_state = double(jev.initialize_vio_state)
    jev.make_vio_estimator_step = steps(jev.make_vio_estimator_step)

    # Under x64 two counts come out int64 where the other lax.cond branch
    # gives int32, and lax.cond refuses the pair: the RANSAC gate's inlier
    # count (estimator.py:534-545) and the VIO keyframe's scene-flow kill
    # count (estimator_vio.py:433-442, :638 / :657). Both go back to int32
    # (a count's width; no value changes).
    gate = jpnp.ransac_pnp_gate

    @functools.wraps(gate)
    def gate32(*a, **k):
        inliers, ok, count = gate(*a, **k)
        return inliers, ok, count.astype(jnp.int32)
    jpnp.ransac_pnp_gate = gate32
    build = jev._build_vio_stages

    @functools.wraps(build)
    def build32(*a, **k):
        st = build(*a, **k)
        kf_pre = st.kf_pre

        def kf_pre32(*a, **k):
            prep = kf_pre(*a, **k)
            return prep._replace(n_dyn=prep.n_dyn.astype(jnp.int32))
        return st._replace(kf_pre=kf_pre32)
    jev._build_vio_stages = build32


def _num(v, fmt):
    return "-" if v is None else format(v, fmt)


TRACE_FIELDS = ("n_tracked", "n_landmarks", "n_ransac_inliers",
                "n_pnp_candidates", "is_keyframe", "pnp_success",
                "ba_success")


class _Trace:
    """--trace: both packages' per-frame step outputs, and the inputs of
    the port's RANSAC gate by frame."""

    def __init__(self):
        import numpy as np

        from rsvio_tpu.models import estimator as jest
        from rsvio_tpu.models import estimator_vio as jev
        from rsvio_tpu_torch.models import estimator as test_
        from rsvio_tpu_torch.models import estimator_vio as tev
        from rsvio_tpu_torch.models import pnp as tpnp

        self.out, self.gate_in = {"jax": [], "port": []}, {}

        def wrap(side, make):
            def wrapped(*a, **k):
                step = make(*a, **k)

                def traced(*args):
                    state, o = step(*args)
                    self.out[side].append(dict(
                        T=np.asarray(o.T_W_B, np.float64),
                        **{f: float(getattr(o, f)) for f in TRACE_FIELDS}))
                    return state, o
                return traced
            return wrapped

        for side, mod, name in (("jax", jest, "make_estimator_step"),
                                ("jax", jev, "make_vio_estimator_step"),
                                ("port", test_, "make_estimator_step"),
                                ("port", tev, "make_vio_estimator_step")):
            setattr(mod, name, wrap(side, getattr(mod, name)))
        self.port_gate = gate = tpnp.ransac_pnp_gate

        def recording_gate(*a, **k):
            self.gate_in[len(self.out["port"])] = (a, k)
            return gate(*a, **k)
        tpnp.ransac_pnp_gate = recording_gate

    def dump(self, frame, path):
        """Write the port's gate inputs of `frame` to `path` (.npz): the
        gate's arrays under their parameter names and the PnPConfig's
        fields under theirs."""
        import numpy as np

        args, kw = self.gate_in[frame]
        names = ("T_W_B_init", "T_C_B", "landmarks", "obs", "mask",
                 "gumbel")
        arrays = {n: a.numpy() for n, a in zip(names, args[:6])}
        arrays["age"] = kw["age"].numpy()
        np.savez_compressed(path, **arrays, **args[6]._asdict())
        print(f"  gate inputs of frame {frame} -> {path}", flush=True)

    def report(self):
        """Print the first frame where the two steps part (and empty the
        record for the next row)."""
        import math

        import jax
        import jax.numpy as jnp
        import numpy as np

        from rsvio_tpu.models import pnp as jpnp

        out, gate_in = self.out, self.gate_in
        self.out, self.gate_in = {"jax": [], "port": []}, {}
        for k, (a, b) in enumerate(zip(out["jax"], out["port"])):
            dT = float(np.abs(a["T"] - b["T"]).max())
            diff = {f: (a[f], b[f]) for f in TRACE_FIELDS if a[f] != b[f]}
            if diff or dT > 1e-9:
                break
        else:
            print("  trace: no frame parts", flush=True)
            return
        print(f"  trace: frames 0-{k - 1} agree; frame {k}: max|dT| "
              f"{dT:.3g}, (jax, port) {diff}", flush=True)
        if k not in gate_in:
            return
        args, kw = gate_in[k]
        T, T_C_B, lm, obs, mask, _, cfg = args
        age = kw.get("age")
        key = jax.random.fold_in(jax.random.PRNGKey(0x5A11AC), k)
        j = jpnp.ransac_pnp_gate(
            *(jnp.asarray(x.numpy()) for x in (T, T_C_B, lm, obs, mask)),
            key, jpnp.PnPConfig(**cfg._asdict()),
            age=None if age is None else jnp.asarray(age.numpy()))
        t = self.port_gate(*args, **kw)
        w = np.clip(age.numpy() / cfg.ransac_age_cap, cfg.ransac_age_floor,
                    1.0) if age is not None else np.ones(lm.shape[0])
        for side, (inl, _, count) in (("jax", j), ("port", t)):
            inl = np.asarray(inl)
            vote = math.fsum((inl * w[None, :]).ravel().tolist())
            print(f"  trace: frame {k} gate on the port's inputs, {side}: "
                  f"{int(count)} inliers, vote {vote!r}", flush=True)


def compare_matrix(width, frames, scenes=None, configs=None,
                   route="gather", geometry="matrix", precision="f32",
                   against=None, trace=False, dump_gate=None):
    """The accuracy matrix's rows through both harnesses on the same JAX
    frames; prints one line a row and returns the rows (dicts with both
    packages' ATE, drift and positions)."""
    import jax
    import numpy as np
    import torch

    from rsvio_tpu.data import synthetic as jsyn
    from rsvio_tpu.utils import evaluation as jeval
    from rsvio_tpu_torch.data import synthetic as tsyn
    from rsvio_tpu_torch.tools import accuracy_matrix as am
    from rsvio_tpu_torch.utils import evaluation as teval

    if geometry == "small":
        H, W, fps = SMALL["H"], SMALL["W"], SMALL["fps"]
        geo = {k: v for k, v in SMALL.items()
               if k not in ("H", "W", "fps", "seed")}
    else:
        H, W, levels, cell, margin = am.geometry(width)
        fps = 20.0
        geo = dict(capacity=256, window=10, levels=levels, cell_size=cell,
                   detect_margin=margin)
    backend = "xla" if route == "gather" else "pallas"
    dtype = torch.float64 if precision == "f64" else torch.float32
    other = {}
    if against:
        with open(against) as f:
            other = {(r["scene"], r["config"]): r
                     for r in json.load(f)["rows"]}
    names = [c for c, _ in am.CONFIGS if not configs or c in configs]
    tracer = _Trace() if trace else None
    rows = []
    print(f"{W}x{H} frames={frames} {geo} route={route} {precision}: "
          f"scene config | ATE jax port (m) | drift jax port (%) | "
          f"max|dpos| (m)" + (" | jax, port vs --against (m)"
                              if against else ""))
    for sname in scenes or list(jsyn.MATRIX_SCENES):
        scene_fn, traj_fn = jsyn.MATRIX_SCENES[sname]
        scene, traj = scene_fn(H=H, W=W), traj_fn()
        tscene = tsyn.MATRIX_SCENES[sname][0](H=H, W=W, device="cpu")
        if geometry == "small":
            rng = np.random.default_rng(SMALL["seed"])
            kw = dict(noise_rng=rng, **am.IMU_BIASES, **am.IMU_NOISE)
        else:
            rng = am.scene_rng(7, sname)
            kw = am.imu_kwargs(rng)
        seq = jsyn.generate_sequence(scene, traj, frames, fps=fps,
                                     imu_rate=200.0, imu_kwargs=kw)
        boot = jeval.static_init_imu(
            traj, rng=rng, gyro_bias=kw["gyro_bias"],
            accel_bias=kw["accel_bias"], gyro_noise=kw["gyro_noise"],
            accel_noise=kw["accel_noise"])
        for cname, ckw in am.CONFIGS:
            if cname not in names:
                continue
            common = dict(backend=backend, **geo, **ckw)
            if ckw["use_vio"]:
                common.update(init_gyro=boot[0], init_accel=boot[1])
            # JAX's Pallas kernel takes float32 only (klt_kernel.py:710;
            # the port casts around its kernel), so in float64 on the
            # kernel route only the port runs.
            port_only = precision == "f64" and route == "kernel"
            jr = None if port_only else jeval.run_synthetic_sequence(
                seq, scene, **common)
            draws = None
            if ckw.get("ransac"):
                key = jax.random.PRNGKey(0x5A11AC)
                # JAX draws in the step's dtype (pnp.py:298).
                jd = [np.array(jax.random.gumbel(
                    jax.random.fold_in(key, k), (ckw["ransac"],
                                                 geo["capacity"] * 2),
                    dtype=jax.numpy.float64 if precision == "f64"
                    else jax.numpy.float32)) for k in range(frames)]
                draws = (lambda fid, shape, dtype, device, jd=jd:
                         torch.from_numpy(jd[fid]).to(dtype=dtype,
                                                      device=device))
            tr = teval.run_synthetic_sequence(seq, tscene, device="cpu",
                                              dtype=dtype, draws=draws,
                                              **common)
            row = dict(scene=sname, config=cname, ate_jax=None,
                       ate_port=tr.ate_rmse, drift_jax=None,
                       drift_port=tr.drift_pct, gap=None, jax=None,
                       port=tr.positions.tolist())
            if jr is not None:
                row.update(ate_jax=jr.ate_rmse, drift_jax=jr.drift_pct,
                           gap=float(np.abs(tr.positions
                                            - jr.positions).max()),
                           jax=jr.positions.tolist())
            rows.append(row)
            line = (f"{sname} {cname} | {_num(row['ate_jax'], '.4f')} "
                    f"{tr.ate_rmse:.4f} | {_num(row['drift_jax'], '.2f')} "
                    f"{tr.drift_pct:.2f} | {_num(row['gap'], '.2e')}")
            o = other.get((sname, cname))
            if o:
                line += " | " + " ".join(_num(
                    None if o[k] is None or row[k] is None else
                    np.abs(np.asarray(o[k]) - np.asarray(row[k])).max(),
                    ".2e") for k in ("jax", "port"))
            print(line, flush=True)
            if dump_gate:
                tracer.dump(int(dump_gate[0]), dump_gate[1])
            if tracer:
                tracer.report()
    return rows


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
