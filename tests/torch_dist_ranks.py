"""Rank functions for the port's distributed tests (spawned by
rsvio_tpu_torch.parallel.dryrun.run_ranks). They import only torch, numpy
and the port: the ranks never import JAX or rsvio_tpu. Inputs come from an
.npz file the test wrote; results go back as the rank's dict of arrays."""

import numpy as np
import torch

from rsvio_tpu_torch.models import ba, vio_ba
from rsvio_tpu_torch.models.imu import GRAVITY, Preintegrated
from rsvio_tpu_torch.models.marginalization import MargPrior, empty_prior
from rsvio_tpu_torch.parallel import dist_ba, dist_vio_ba


def load(path, prefix, dtype=None):
    """The arrays of `path` whose keys start with prefix + ".", by their
    remaining name; floats cast to `dtype` when given."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            if k.startswith(prefix + "."):
                a = torch.from_numpy(z[k])
                if dtype is not None and a.is_floating_point():
                    a = a.to(dtype)
                out[k[len(prefix) + 1:]] = a
    return out


def flatten(name, x, out):
    """Store a result (NamedTuples of tensors, nested) as name.field keys."""
    if isinstance(x, tuple):
        fields = getattr(x, "_fields", [str(i) for i in range(len(x))])
        for f, v in zip(fields, x):
            flatten(f"{name}.{f}", v, out)
    elif x is not None:
        out[name] = (x.detach().cpu().numpy() if torch.is_tensor(x)
                     else np.asarray(x))


def vo_args(p):
    return (p["T_W_B"], p["T_C_B"], p["lms"], p["obs"], p["mask"],
            p["lm_valid"])


def vio_args(p):
    st = vio_ba.VIOState(T_W_B=p["T_W_B"], vel=p["vel"], bg=p["bg"],
                         ba=p["ba"])
    pre = Preintegrated(*(p[f"pre.{f}"] for f in Preintegrated._fields))
    return (st, p["T_C_B"], p["lms"], p["obs"], p["mask"], p["lm_valid"],
            pre, p["pre_valid"])


def prior_of(p, W, B, dtype):
    if "prior.H" in p:
        return MargPrior(*(p[f"prior.{f}"] for f in MargPrior._fields))
    return empty_prior(W, B, dtype=dtype, device="cpu")


def run_case(mesh, kind, p, cfg_kw, dtype):
    """One sharded solve of `kind` on the inputs p; returns its result."""
    w = p.get("obs_weight")
    yes = torch.ones((), dtype=torch.bool)
    if kind == "ba":
        return dist_ba.solve_ba_distributed(
            mesh, *vo_args(p), ba.BAConfig(**cfg_kw), obs_weight=w)
    if kind == "ba_marg":
        W = p["T_W_B"].shape[0]
        return dist_ba.solve_ba_marginalized_distributed(
            mesh, *vo_args(p), prior_of(p, W, 6, dtype), yes,
            ba.BAConfig(**cfg_kw), obs_weight=w)
    if kind == "vio":
        return dist_vio_ba.solve_vio_ba_distributed(
            mesh, *vio_args(p), vio_ba.VIOBAConfig(**cfg_kw), obs_weight=w)
    W = p["T_W_B"].shape[0]
    return dist_vio_ba.solve_vio_ba_marginalized_distributed(
        mesh, *vio_args(p), prior_of(p, W, 15, dtype), yes,
        vio_ba.VIOBAConfig(**cfg_kw), obs_weight=w)


def solver_cases(mesh, path, cases):
    """Every (name, kind, input prefix, cfg kwargs, "f32"/"f64") of
    `cases` on this rank, results flattened under the name, and the
    mesh's all-reduce bytes of each solve under allreduce_bytes.name.
    A name ending in "bad_L" records whether the solve raised
    ValueError."""
    out = {}
    for name, kind, prefix, cfg_kw, dname in cases:
        dtype = torch.float64 if dname == "f64" else torch.float32
        p = load(path, prefix, dtype)
        if name.endswith("bad_L"):
            try:
                run_case(mesh, kind, p, cfg_kw, dtype)
                out[name] = np.array(False)
            except ValueError:
                out[name] = np.array(True)
            continue
        before = mesh.counts["all_reduce_bytes"]
        flatten(name, run_case(mesh, kind, p, cfg_kw, dtype), out)
        out[f"allreduce_bytes.{name}"] = np.array(
            mesh.counts["all_reduce_bytes"] - before)
    return out


# ---------------------------------------------------------------- steps

def step_config(use_marg: bool, vio: bool):
    """tests/test_dist_estimator.py's tiny VO config (120x160, capacity 96,
    window 4, 3 levels) in the port, as a VIO config when `vio`."""
    from rsvio_tpu_torch.models import estimator as est
    from rsvio_tpu_torch.models import estimator_vio as ev
    from rsvio_tpu_torch.models.frontend import FrontendConfig
    from rsvio_tpu_torch.ops.klt import KLTConfig
    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=96, cell_size=28, detect_margin=10,
                                min_score=5.0,
                                klt=KLTConfig(levels=3, max_iterations=12)),
        window_size=4, translation_threshold=0.012, rotation_threshold=0.05,
        image_shape=(120, 160), use_marginalization=use_marg)
    return ev.VIOEstimatorConfig(base=cfg) if vio else cfg


def step_rig():
    from rsvio_tpu_torch.models import estimator as est
    from rsvio_tpu_torch.ops import cameras
    params = cameras.pack_params(cameras.PINHOLE_RADTAN,
                                 [120.0, 120.0, 80.0, 60.0], [0, 0, 0, 0],
                                 device="cpu")
    T_r = torch.eye(4)
    T_r[0, 3] = 0.11
    return est.make_rig(params, params, torch.eye(4), T_r)


def hover_imu(S=10):
    """test_dist_estimator.py's IMU buffer: no rotation, gravity."""
    accel = np.zeros((S, 3), np.float32)
    accel[:, 2] = GRAVITY
    return (np.zeros((S, 3), np.float32), accel,
            np.full(S, 0.005, np.float32), np.ones(S, bool))


def run_steps(step, vio: bool, cfg, frames):
    """Per-frame T_W_B, is_keyframe, ba_success and the final velocity of
    `step` over `frames` ((N, 2, H, W) array); a compiled step's outputs
    are copied out before its next-but-one call overwrites them."""
    from rsvio_tpu_torch.models import estimator as est
    from rsvio_tpu_torch.models import estimator_vio as ev
    rig = step_rig()
    state = (ev.init_vio_state(cfg, device="cpu") if vio
             else est.init_state(cfg, device="cpu"))
    imu = hover_imu() if vio else ()
    T, kf, ba_ok = [], [], []
    for a, b in torch.from_numpy(frames):
        state, out = step(state, rig, a, b, *imu)
        T.append(out.T_W_B.numpy().copy())
        kf.append(bool(out.is_keyframe))
        ba_ok.append(bool(out.ba_success))
    return {"T_W_B": np.stack(T), "is_keyframe": np.array(kf),
            "ba_success": np.array(ba_ok),
            "vel": (state.vel.numpy() if vio else np.zeros(3))}


def step_cases(mesh, path, runs):
    """The distributed steps over the frames of `path` for each
    (name, use_marg, vio, n_frames) of `runs`, and the multihost helpers
    on this rank."""
    from rsvio_tpu_torch.parallel import multihost
    from rsvio_tpu_torch.parallel.dist_estimator import (
        make_distributed_estimator_step, make_distributed_vio_estimator_step)
    with np.load(path) as z:
        frames = z["frames"]
    out = {}
    for name, use_marg, vio, n in runs:
        cfg = step_config(use_marg, vio)
        make = (make_distributed_vio_estimator_step if vio
                else make_distributed_estimator_step)
        for k, v in run_steps(make(cfg, mesh), vio, cfg, frames[:n]).items():
            out[f"{name}.{k}"] = v
    out["host_local_slice"] = np.array(multihost.host_local_slice(8))
    out["shard"] = multihost.shard_landmark_arrays(
        mesh, torch.arange(12.0).reshape(2, 6), axis_index=1).numpy()
    a, b = mesh.all_reduce_packed(torch.full((2,), 0.5 + mesh.rank),
                                  torch.tensor(3 + mesh.rank))
    out["packed"] = np.concatenate([a.numpy(), [float(b)]])
    out["packed_dtypes"] = np.array([str(a.dtype), str(b.dtype)])
    return out


def compiled_step_cases(mesh, path, runs):
    """The eager and the compiled distributed steps over the frames of
    `path` for each (name, use_marg, vio, n_frames) of `runs`, under
    name.eager.* and name.compiled.*: run_steps' records, the mesh's count
    increments over the run (``counts``, in sorted key order), and for the
    compiled step its blocking reads and each frame's variant keys."""
    from rsvio_tpu_torch.parallel.dist_estimator import (
        make_compiled_distributed_estimator_step,
        make_compiled_distributed_vio_estimator_step,
        make_distributed_estimator_step, make_distributed_vio_estimator_step)
    with np.load(path) as z:
        frames = z["frames"]
    makers = {False: (make_distributed_estimator_step,
                      make_compiled_distributed_estimator_step),
              True: (make_distributed_vio_estimator_step,
                     make_compiled_distributed_vio_estimator_step)}
    out = {}
    for name, use_marg, vio, n in runs:
        cfg = step_config(use_marg, vio)
        for kind, make in zip(("eager", "compiled"), makers[vio]):
            step, keys = make(cfg, mesh), []

            def call(*args, step=step, keys=keys):
                res = step(*args)
                keys.append(repr(getattr(step, "last_variants", None)))
                return res
            c0 = dict(mesh.counts)
            got = run_steps(call, vio, cfg, frames[:n])
            got["counts"] = np.array([mesh.counts[k] - c0[k]
                                      for k in sorted(c0)])
            if kind == "compiled":
                got["host_reads"] = np.array(step.host_reads)
                got["variants"] = np.array(keys)
            for k, v in got.items():
                out[f"{name}.{kind}.{k}"] = v
    return out


# ---------------------------------------------------------------- CUDA

def cuda_solver_parity(mesh, L=64):
    """The four sharded solvers on this rank's device against the
    single-device solvers there, on dryrun's W=10 windows with L
    landmarks: per solver success flags, the pose gap beyond
    1e-3 |single| + 1e-4 (<= 0 within), the prior's H gap over max|H|,
    and the poses."""
    from rsvio_tpu_torch.parallel import dryrun
    dev = mesh.device
    prob = dryrun.window_problem(10, L, seed=2, device=dev)
    vargs = dryrun.vio_window_problem(10, L, seed=2, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    cases = {
        "ba": (lambda: dist_ba.solve_ba_distributed(mesh, *prob),
               lambda: ba.solve_ba(*prob)),
        "ba_marg": (lambda: dist_ba.solve_ba_marginalized_distributed(
            mesh, *prob, empty_prior(10, 6, device=dev), yes),
            lambda: ba.solve_ba_marginalized(
                *prob, empty_prior(10, 6, device=dev), yes)),
        "vio": (lambda: dist_vio_ba.solve_vio_ba_distributed(mesh, *vargs),
                lambda: vio_ba.solve_vio_ba(*vargs)),
        "vio_marg": (
            lambda: dist_vio_ba.solve_vio_ba_marginalized_distributed(
                mesh, *vargs, empty_prior(10, 15, device=dev), yes),
            lambda: vio_ba.solve_vio_ba_marginalized(
                *vargs, empty_prior(10, 15, device=dev), yes))}
    out = {}
    for name, (dist_fn, single_fn) in cases.items():
        rd, rs = dist_fn(), single_fn()
        (rd, pd), (rs, ps) = ((r if isinstance(r, tuple)
                               and not hasattr(r, "success") else (r, None))
                              for r in (rd, rs))
        td = rd.state.T_W_B if hasattr(rd, "state") else rd.T_W_B
        ts = rs.state.T_W_B if hasattr(rs, "state") else rs.T_W_B
        out[f"{name}.success"] = np.array([bool(rd.success),
                                           bool(rs.success)])
        out[f"{name}.excess"] = np.array(float(
            ((td - ts).abs() - (1e-4 + 1e-3 * ts.abs())).max()))
        out[f"{name}.T_W_B"] = td.cpu().numpy()
        out[f"{name}.landmarks_gap"] = np.array(float(
            (rd.landmarks - rs.landmarks).abs().max()))
        if pd is not None:
            out[f"{name}.dH"] = np.array(float((pd.H - ps.H).abs().max())
                                         / max(1.0, float(ps.H.abs().max())))
    return out
