"""Shared player loop: drives the estimator over a dataset with real-time
pacing, per-stage timing, viewer logging, statistics and trajectory export.

Port of rsvio_tpu/cli/run.py (the reference's EurocPlayer::run, ref
src/datasets/euroc_player.rs:20-176), VO and ``--vio``: the same options,
log lines, statistics and output files. What differs:

  * ``--device {cuda,cpu}`` (default cuda; cuda without a GPU raises).
  * Frames are decoded by ``data.png`` on the prefetch thread and handed
    out as pinned uint8 tensors; the loop uploads them with
    ``non_blocking=True`` and casts on the device.
  * The scalars the loop reads each frame (pose, keyframe / PnP / BA flags,
    counts, health; with a viewer also the table and map) are stacked on
    the device and read with ONE device-to-host copy per frame, which also
    stands in for JAX's ``block_until_ready``. The step's own host syncs
    (its data-dependent branches) are the step's.
  * A frame whose step fails is logged, skipped and counted in
    ``PlayerResult.n_failed``, unless the failure is the kernel layer's (a
    build or launch error, a CUDA error): that is raised.
  * On the card the step is compiled (CUDA graphs of its segments:
    models/estimator.make_compiled_estimator_step, for ``--vio``
    models/estimator_vio.make_compiled_vio_estimator_step), as the JAX CLI
    runs its jitted step; ``--stage-timing`` and the CPU run the eager
    step.
  * ``--vio``: each frame's IMU buffer (64 masked samples) is built on
    the host and handed to the VIO step as host arrays, which the step
    uploads as one pinned copy.
  * The trace of ``--profile-dir`` is torch.profiler's (Chrome trace),
    with the compiled step's spans (rsvio_tpu_torch.profiling) over their
    CUDA calls. The ``[Timing]`` line (DEBUG, shown without ``--quiet``)
    sums the frame's spans by name; the tracer records while it is shown.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

log = logging.getLogger("rsvio")

# FrameOutput fields the loop reads every frame.
OUT_FIELDS = ("T_W_B", "is_keyframe", "pnp_success", "ba_success",
              "ba_iterations", "n_tracked", "n_landmarks", "pose_ok",
              "health", "n_ransac_inliers", "n_pnp_candidates")


@dataclass
class PlayerConfig:
    """(ref src/datasets/mod.rs:64-71)"""
    enable_statistics: bool = True
    enable_console_statistics: bool = True
    step_mode: bool = False
    realtime: bool = False
    max_frames: Optional[int] = None
    enable_viewer: bool = False
    viewer_dir: Optional[str] = None    # write visualization artifacts here
    trajectory_out: Optional[str] = None
    use_vio: bool = False       # visual-inertial mode (IMU preintegration)
    checkpoint_out: Optional[str] = None
    checkpoint_in: Optional[str] = None
    checkpoint_every: Optional[int] = None  # periodic snapshot every N frames
    profile_dir: Optional[str] = None   # torch.profiler trace directory
    evaluate_ate: bool = False  # compute ATE vs dataset ground truth at end
    # Tri-state override of the YAML solver.marginalization key (None =
    # respect the config file).
    marginalization: Optional[bool] = None
    # Per-frame stage-split [Timing] log (ref estimator.rs:252-259), with a
    # device sync between stages. Diagnosis mode, slower than the step.
    stage_timing: bool = False
    device: str = "cuda"


@dataclass
class PlayerResult:
    """(ref src/datasets/mod.rs:55-62), plus the frames whose step failed
    and the prefetch thread's load time of each frame."""
    success: bool = False
    frame_processing_times_ms: List[float] = field(default_factory=list)
    avg_processing_time_ms: float = 0.0
    n_failed: int = 0
    decode_times_ms: List[float] = field(default_factory=list)


def setup_logging(verbose: bool = True):
    """ANSI-colored ms-timestamped log format (ref run_euroc.rs:14-35)."""
    level = logging.DEBUG if verbose else logging.INFO
    logging.basicConfig(
        level=level,
        format="\x1b[90m%(asctime)s.%(msecs)03d\x1b[0m "
               "\x1b[36m%(levelname).1s\x1b[0m %(name)s: %(message)s",
        datefmt="%H:%M:%S")


def _imu_buffer_for_frame(imu_data, prev_ts, cur_ts, buf: int = 64,
                          np_dtype=np.float32):
    """Fixed-capacity masked IMU buffer (host numpy) for the interval
    (prev_ts, cur_ts]: gyro (buf,3), accel (buf,3), dts (buf,), mask."""
    gyro = np.zeros((buf, 3), np_dtype)
    accel = np.zeros((buf, 3), np_dtype)
    dts = np.zeros((buf,), np_dtype)
    mask = np.zeros((buf,), bool)
    if prev_ts is not None:
        ts = imu_data["ts"]
        sel = np.nonzero((ts > prev_ts) & (ts <= cur_ts))[0][:buf]
        n = len(sel)
        if n:
            gyro[:n] = imu_data["gyro"][sel]
            accel[:n] = imu_data["accel"][sel]
            t = ts[sel].astype(np.float64)
            prev = np.concatenate([[prev_ts], t[:-1]])
            dts[:n] = ((t - prev) * 1e-9).astype(np_dtype)
            mask[:n] = True
    return gyro, accel, dts, mask


def vio_config(cfg, ecfg):
    """The VIO estimator config of the CLI: the base config, the imu:
    section and the solver keys the JAX CLI maps (rsvio_tpu/cli/run.py;
    the window solve's max_iterations stays at its default there, 20)."""
    from ..models import estimator_vio as ev
    from ..models.vio_ba import VIOBAConfig
    from ..utils.config import make_imu_params

    s = cfg.solver
    return ev.VIOEstimatorConfig(
        base=ecfg, imu_params=make_imu_params(cfg),
        vio=VIOBAConfig(huber_delta=s.huber_delta, cost_tol=s.cost_tol,
                        param_tol=s.param_tol, chi2_gate=s.chi2_gate,
                        chi2_gate_iter=s.chi2_gate_iter,
                        bias_gyro_weight=s.bias_gyro_weight,
                        bias_accel_weight=s.bias_accel_weight,
                        bias_gyro_weight_desert=s.bias_gyro_weight_desert,
                        bias_accel_weight_desert=s.bias_accel_weight_desert,
                        min_lm_span=s.min_lm_span))


def vio_bootstrap(vcfg, imu_data, dtype, dev):
    """The VIO state: the gravity-aligned bootstrap from the first 0.5 s
    of IMU when it is quasi-static (>= 5 samples), else identity."""
    from ..models import estimator_vio as ev

    ts0 = imu_data["ts"][0]
    init_sel = imu_data["ts"] <= ts0 + int(0.5e9)
    if init_sel.sum() >= 5:
        static_ok, info = ev.quasi_static_check(
            imu_data["gyro"][init_sel], imu_data["accel"][init_sel])
        if static_ok:
            log.info("VIO init: gravity-aligned attitude + gyro bias from "
                     "%d static samples", int(init_sel.sum()))
            return ev.initialize_vio_state(
                vcfg, imu_data["gyro"][init_sel],
                imu_data["accel"][init_sel], dtype=dtype, device=dev)
        log.warning("VIO init: first 0.5 s of IMU not quasi-static "
                    "(gyro_std=%.4f accel_std=%.3f |accel|=%.3f) — using "
                    "identity init", info["gyro_std"], info["accel_std"],
                    info["accel_norm"])
    return ev.init_vio_state(vcfg, dtype=dtype, device=dev)


def resolve_device(name: str):
    """torch.device for --device; cuda without a usable GPU raises (the
    port never drops to the CPU on its own)."""
    import torch

    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    return dev


def fetch(values: dict) -> dict:
    """Read every tensor of `values` (name -> tensor or Python scalar) to
    numpy with one device-to-host copy: the tensors are flattened, cast to
    float64 (exact for bool, int32, float32 and float64) and concatenated
    on their device, copied once, then split and cast back."""
    import torch

    names = [k for k, v in values.items() if torch.is_tensor(v)]
    out = {k: np.asarray(v) for k, v in values.items()
           if not torch.is_tensor(v)}
    if not names:
        return out
    flat = torch.cat([values[k].reshape(-1).to(torch.float64)
                      for k in names]).cpu().numpy()
    i = 0
    for k in names:
        t = values[k]
        n = t.numel()
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[k] = flat[i:i + n].reshape(tuple(t.shape)).astype(np_dtype)
        i += n
    return out


def is_kernel_failure(e: BaseException) -> bool:
    """A failure of the kernel layer (a library that did not build, load
    or launch; a CUDA graph that did not capture or replay; a CUDA error),
    which the loop raises instead of skipping the frame."""
    import torch

    from ..ops.cuda.build import KernelError
    from ..utils.graphs import GraphError

    accel = getattr(torch, "AcceleratorError", None)
    return (isinstance(e, (KernelError, GraphError,
                           torch.cuda.OutOfMemoryError))
            or (accel is not None and isinstance(e, accel))
            or (isinstance(e, RuntimeError) and "CUDA" in str(e)))


def uploader(dev, dtype):
    """uint8 CPU frame tensor -> `dtype` on `dev`: an asynchronous copy
    from pinned memory on CUDA, then the cast on the device."""
    if dev.type == "cuda":
        return lambda t: t.to(dev, non_blocking=True).to(dtype)
    return lambda t: t.to(dtype)


def run_player(player, config_path: str, pcfg: PlayerConfig) -> PlayerResult:
    """Run the full pipeline over `player`'s frames."""
    import torch

    from .. import profiling
    from ..data.players import prefetch_frames
    from ..models import estimator as est
    from ..ops.klt import resolve_backend
    from ..utils.checkpoint import load_state, save_state
    from ..utils.config import load_config, make_estimator_config
    from ..utils.trajectory import save_tum
    from ..viewers import NullViewer, create_viewer
    from .playback import PlaybackController

    dev = resolve_device(pcfg.device)
    cfg = load_config(config_path)
    if pcfg.marginalization is not None:
        cfg.solver.marginalization = pcfg.marginalization
    if cfg.solver.marginalization:
        log.info("marginalization: evicted keyframes fold into a dense prior")
    dtype = torch.float64 if cfg.precision == "f64" else torch.float32
    if cfg.precision == "f64":
        log.info("precision: f64 (float64 state and images; the KLT kernel "
                 "tracks in float32)")
    ecfg, rig = make_estimator_config(cfg, kind="vo", device=dev)
    if resolve_backend(ecfg.frontend.klt) == "xla":
        log.warning(
            "tracker routed to the gather path (tracker backend: xla, or "
            "bicubic interpolation) — plain PyTorch with no KLT kernel, "
            "orders of magnitude slower than the kernel route on the GPU")
    log.info("device: %s", dev)

    imu_data = None
    if pcfg.use_vio:
        from ..models import estimator_vio as ev
        samples = player.load_imu() if hasattr(player, "load_imu") else []
        if samples:
            imu_data = {
                "ts": np.asarray([s_.timestamp_ns for s_ in samples]),
                "gyro": np.asarray([s_.gyro for s_ in samples], np.float32),
                "accel": np.asarray([s_.accel for s_ in samples],
                                    np.float32)}
            # The config resolved for the VIO estimator kind.
            ecfg, rig = make_estimator_config(cfg, kind="vio", device=dev)
            vcfg = vio_config(cfg, ecfg)
            # On the card the VIO step runs as CUDA graphs, as the JAX CLI
            # runs its jitted step.
            step = (ev.make_compiled_vio_estimator_step(vcfg, device=dev)
                    if dev.type == "cuda"
                    else ev.make_vio_estimator_step(vcfg))
            state = vio_bootstrap(vcfg, imu_data, dtype, dev)
            log.info("VIO mode: %d IMU samples loaded", len(samples))
        else:
            log.warning("VIO requested but no IMU data found; running VO")
    stage_step = None
    if imu_data is None:
        if pcfg.stage_timing:
            stage_step = est.make_estimator_split_step(ecfg)
            log.info("stage-timing mode: synchronized estimator stages "
                     "(%s)", "/".join(est.STAGE_NAMES))
        # On the card the VO step runs as CUDA graphs, as the JAX CLI runs
        # its jitted step; --stage-timing keeps the synchronized stages.
        step = (est.make_compiled_estimator_step(ecfg, device=dev)
                if dev.type == "cuda" and stage_step is None
                else est.make_estimator_step(ecfg))
        state = est.init_state(ecfg, dtype=dtype, device=dev)
    elif pcfg.stage_timing:
        log.warning("--stage-timing is VO-only; ignored in VIO mode")
    imu_np_dtype = np.float64 if cfg.precision == "f64" else np.float32
    if pcfg.checkpoint_in:
        state = load_state(pcfg.checkpoint_in, state)
        log.info("resumed state from %s", pcfg.checkpoint_in)

    viewer = create_viewer(pcfg.enable_viewer, pcfg.viewer_dir)
    # A NullViewer reads nothing: the frame's one batched read stays small.
    viewer_on = not isinstance(viewer, NullViewer)
    intr = rig.params[0][:4].cpu().numpy() if viewer_on else None

    n_frames = len(player)
    if pcfg.max_frames:
        n_frames = min(n_frames, pcfg.max_frames)
    log.info("dataset: %d frames (processing %d)", len(player), n_frames)

    result = PlayerResult()
    timestamps: List[int] = []
    poses: List[np.ndarray] = []
    kf_trajectory: List[tuple] = []   # (timestamp_ns, pose) per keyframe
    prev_ts = None
    upload = uploader(dev, dtype)
    H_img, W_img = ecfg.image_shape

    profile_ctx = None
    if pcfg.profile_dir:
        profile_ctx = profiling.torch_trace(pcfg.profile_dir)
        profile_ctx.__enter__()
        log.info("torch.profiler trace -> %s", pcfg.profile_dir)
    # The [Timing] line's spans are recorded while it is printed (DEBUG).
    timing_ctx = (profiling.recording() if log.isEnabledFor(logging.DEBUG)
                  else None)
    if timing_ctx is not None:
        timing_ctx.__enter__()

    playback = PlaybackController(pcfg.step_mode, log=log)
    if pcfg.step_mode:
        log.info("step mode: <enter> = next frame, a<enter> = toggle "
                 "auto-play, q<enter> = quit")

    frame_it = prefetch_frames(
        player, 0, n_frames,
        pin=dev.type == "cuda",
        decode_ms=result.decode_times_ms)
    k = -1
    try:
        while True:
            # A load failure stops the run but keeps the frames done so far
            # (trajectory, statistics and checkpoint are still written).
            try:
                frame = next(frame_it)
            except StopIteration:
                break
            except Exception as e:
                log.error("frame loading failed after frame %d: %s — "
                          "stopping early, keeping results so far", k, e)
                result.n_failed += 1
                break
            k += 1
            t_start = time.time()
            try:
                if frame.left.shape != (H_img, W_img) or \
                        frame.right.shape != (H_img, W_img):
                    raise ValueError(
                        f"image {frame.left.shape} / {frame.right.shape}, "
                        f"config {(H_img, W_img)}")
                with profiling.span("frame_creation"):
                    img_l, img_r = (upload(t) for t in frame.tensors)
                with profiling.span("process_frame"):
                    if imu_data is not None:
                        state, out = step(
                            state, rig, img_l, img_r,
                            *_imu_buffer_for_frame(
                                imu_data, prev_ts, frame.timestamp_ns,
                                buf=64, np_dtype=imu_np_dtype))
                    elif stage_step is not None:
                        state, out, stage_ms = stage_step(state, rig, img_l,
                                                          img_r)
                        log.debug(
                            "[Timing] frame %d stages: %s", k,
                            ", ".join(f"{n}: {stage_ms[n]:.2f} ms"
                                      for n in est.STAGE_NAMES))
                    else:
                        state, out = step(state, rig, img_l, img_r)
                    reads = {f: getattr(out, f) for f in OUT_FIELDS}
                    if viewer_on:
                        tb = state.table
                        reads.update(alive=tb.alive, fid=tb.fid,
                                     pos0=tb.pos0, pos1=tb.pos1,
                                     lm=state.lm, lm_fid=state.lm_fid,
                                     kf_count=state.kf_count,
                                     kf_T_W_B=state.kf_T_W_B)
                    h = fetch(reads)
            except Exception as e:  # per-frame errors (ref :110-114)
                if is_kernel_failure(e):
                    raise
                log.error("frame %d failed: %s", k, e)
                result.n_failed += 1
                continue
            elapsed_ms = (time.time() - t_start) * 1000.0
            result.frame_processing_times_ms.append(elapsed_ms)

            T = h["T_W_B"]
            timestamps.append(frame.timestamp_ns)
            poses.append(T)
            if bool(h["is_keyframe"]):
                kf_trajectory.append((frame.timestamp_ns, T))

            # Numerical-health column: step_m, the translation since the
            # previous frame, shows a runaway long before any NaN.
            pose_ok = bool(h["pose_ok"])
            step_m = (float(np.linalg.norm(T[:3, 3] - poses[-2][:3, 3]))
                      if len(poses) > 1 else 0.0)
            if not pose_ok:
                log.warning("frame %d: non-finite pose RECOVERED to last "
                            "keyframe (health gate)", k)
            log.debug(
                "[Timing] frame %d: %.1f ms | kf=%d pnp=%d ba=%d(it=%d) "
                "tracked=%d lm=%d | health ok=%d h=%.2f inl=%d/%d "
                "step=%.3fm | %s", k, elapsed_ms,
                int(h["is_keyframe"]), int(h["pnp_success"]),
                int(h["ba_success"]), int(h["ba_iterations"]),
                int(h["n_tracked"]), int(h["n_landmarks"]), int(pose_ok),
                float(h["health"]), int(h["n_ransac_inliers"]),
                int(h["n_pnp_candidates"]), step_m, profiling.report())

            if viewer_on:
                # Entity schema of ref estimator.rs:272-364.
                viewer.set_frame(k, frame.timestamp_ns)
                alive = h["alive"]
                fids = h["fid"][alive]
                viewer.log_image_with_features_colored(
                    "stereo/left", frame.left, h["pos0"][alive], fids)
                viewer.log_image_with_features_colored(
                    "stereo/right", frame.right, h["pos1"][alive], fids)
                viewer.log_pose("pose_current", T)
                lm_valid = (h["lm_fid"] == h["fid"]) & (h["lm_fid"] >= 0)
                if lm_valid.any():
                    viewer.log_points_colored("map/points",
                                              h["lm"][lm_valid],
                                              h["lm_fid"][lm_valid])
                for i in range(int(h["kf_count"])):
                    viewer.log_camera_frustum(f"pose_{i}", h["kf_T_W_B"][i],
                                              intr, (W_img, H_img))
                if len(poses) > 1:
                    viewer.log_trajectory(
                        "trajectory/path",
                        np.asarray([p[:3, 3] for p in poses]))

            # Periodic crash-safe checkpoint.
            if (pcfg.checkpoint_every and pcfg.checkpoint_out
                    and (k + 1) % pcfg.checkpoint_every == 0):
                save_state(pcfg.checkpoint_out, state)
                log.debug("periodic checkpoint at frame %d -> %s", k,
                          pcfg.checkpoint_out)

            # Real-time pacing (ref euroc_player.rs:124-133)
            if pcfg.realtime and prev_ts is not None:
                interval = (frame.timestamp_ns - prev_ts) * 1e-9
                remaining = interval - (time.time() - t_start)
                if remaining > 0:
                    time.sleep(remaining)
            prev_ts = frame.timestamp_ns

            # Interactive playback gate (ref src/datasets/mod.rs:30-50).
            if not playback.wait_for_advance():
                log.info("playback quit at frame %d", k)
                break
    finally:
        frame_it.close()
        if timing_ctx is not None:
            timing_ctx.__exit__(None, None, None)
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)

    times = result.frame_processing_times_ms
    if times:
        result.avg_processing_time_ms = float(np.mean(times))
        result.success = True
    if result.n_failed:
        log.warning("%d frame(s) failed", result.n_failed)

    # Trajectory export (TUM format): per frame and keyframes only.
    if pcfg.trajectory_out and poses:
        save_tum(pcfg.trajectory_out, timestamps, poses)
        log.info("trajectory (%d poses) -> %s", len(poses),
                 pcfg.trajectory_out)
        if kf_trajectory:
            root_name, ext = os.path.splitext(pcfg.trajectory_out)
            kf_path = f"{root_name}_keyframes{ext or '.txt'}"
            save_tum(kf_path, [t for t, _ in kf_trajectory],
                     [p_ for _, p_ in kf_trajectory])
            log.info("keyframe trajectory (%d poses) -> %s",
                     len(kf_trajectory), kf_path)

    if pcfg.checkpoint_out:
        save_state(pcfg.checkpoint_out, state)
        log.info("state checkpoint -> %s", pcfg.checkpoint_out)

    ate = evaluate_ate(player, timestamps, poses) \
        if pcfg.evaluate_ate and poses else None

    # Statistics (ref euroc_player.rs:147-171, :325-346)
    if pcfg.enable_console_statistics and times:
        fps = 1000.0 / result.avg_processing_time_ms
        log.info("=" * 50)
        log.info("Processing complete: %d frames", len(times))
        log.info("Average processing time: %.2f ms (%.1f fps)",
                 result.avg_processing_time_ms, fps)
        log.info("=" * 50)
    if pcfg.enable_statistics and times:
        stats_path = os.path.join(getattr(player, "root", "."),
                                  "statistics.txt")
        try:
            with open(stats_path, "w") as f:
                f.write(f"frames_processed: {len(times)}\n")
                f.write(f"avg_processing_time_ms: "
                        f"{result.avg_processing_time_ms:.3f}\n")
                f.write(f"fps: {1000.0 / result.avg_processing_time_ms:.3f}\n")
                if ate is not None:
                    f.write(f"ate_rmse_m: {ate:.6f}\n")
            log.info("statistics -> %s", stats_path)
        except OSError as e:
            log.warning("could not write statistics: %s", e)

    return result


def evaluate_ate(player, timestamps, poses) -> Optional[float]:
    """ATE RMSE of the run against the dataset's ground truth (EuRoC csv
    stamped in ns or s, or 4Seasons GNSSPoses.txt); None without one."""
    from ..utils.trajectory import (associate, ate_rmse, load_gnss_poses,
                                    load_tum)

    gt = (player.ground_truth_file()
          if hasattr(player, "ground_truth_file") else None)
    if not gt:
        log.warning("ATE requested but the dataset has no ground truth")
        return None
    if os.path.basename(gt).startswith("GNSSPoses"):
        ts_g_ns, pos_g, _ = load_gnss_poses(gt)
        ts_g = ts_g_ns.astype(np.float64) * 1e-9
    else:
        ts_g, pos_g, _ = load_tum(gt)
        if len(ts_g) and ts_g.max() > 1e14:   # ns-stamped CSV (EuRoC)
            ts_g = ts_g * 1e-9
    ts_e = np.asarray(timestamps, dtype=np.float64) * 1e-9
    pos_e = np.asarray([p[:3, 3] for p in poses])
    ia, ib = associate(ts_e, ts_g)
    if len(ia) < 3:
        log.warning("ATE: only %d timestamp associations; skipped", len(ia))
        return None
    ate, _ = ate_rmse(pos_e[ia], pos_g[ib])
    log.info("ATE RMSE vs ground truth: %.4f m (%d associations)", ate,
             len(ia))
    return ate


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the estimator runs (default cuda; cuda "
                         "without a GPU is an error)")


def make_cli(player_cls, name: str):
    """Build a main() for one dataset (ref src/bin/run_euroc.rs:9-73: two
    positional args, config then dataset path). main(argv) returns the
    exit code and keeps the run's PlayerResult in ``main.last_result``."""

    def main(argv=None):
        ap = argparse.ArgumentParser(description=f"Run {name} stereo VO")
        ap.add_argument("config_file")
        ap.add_argument("dataset_path")
        ap.add_argument("--max-frames", type=int, default=None)
        ap.add_argument("--realtime", action="store_true")
        ap.add_argument("--step-mode", action="store_true")
        ap.add_argument("--viewer", action="store_true",
                        help="the rerun viewer (needs the rerun SDK)")
        ap.add_argument("--viewer-dir", default=None,
                        help="write visualization artifacts (PNG overlays, "
                             "PLY map, SVG trajectory) to this directory")
        ap.add_argument("--trajectory-out", default=None)
        ap.add_argument("--vio", action="store_true",
                        help="visual-inertial mode (IMU preintegration)")
        ap.add_argument("--marginalization",
                        action=argparse.BooleanOptionalAction, default=None,
                        help="Schur-marginalize evicted keyframes into a "
                             "dense prior (--no-marginalization forces "
                             "FIFO; default: respect the YAML key)")
        ap.add_argument("--checkpoint-out", default=None)
        ap.add_argument("--checkpoint-in", default=None)
        ap.add_argument("--checkpoint-every", type=int, default=None,
                        help="periodic snapshot every N frames "
                             "(needs --checkpoint-out)")
        ap.add_argument("--eval-ate", action="store_true",
                        help="compute ATE vs the dataset ground truth")
        ap.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler (Chrome) trace here")
        ap.add_argument("--stage-timing", action="store_true",
                        help="per-frame 4-stage [Timing] split (device "
                             "syncs between stages; VO only)")
        ap.add_argument("--quiet", action="store_true")
        add_device_arg(ap)
        args = ap.parse_args(argv)
        setup_logging(verbose=not args.quiet)
        np.random.seed(42)  # ref run_euroc.rs seed
        player = player_cls(args.dataset_path)
        pcfg = PlayerConfig(
            step_mode=args.step_mode, realtime=args.realtime,
            max_frames=args.max_frames, enable_viewer=args.viewer,
            viewer_dir=args.viewer_dir,
            trajectory_out=args.trajectory_out, use_vio=args.vio,
            checkpoint_out=args.checkpoint_out,
            checkpoint_in=args.checkpoint_in,
            checkpoint_every=args.checkpoint_every,
            profile_dir=args.profile_dir,
            evaluate_ate=args.eval_ate,
            marginalization=args.marginalization,
            stage_timing=args.stage_timing,
            device=args.device)
        res = run_player(player, args.config_file, pcfg)
        main.last_result = res
        return 0 if res.success else -1

    main.last_result = None
    return main
