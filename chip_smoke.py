"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device and the CUDA toolkit (nvcc); exits non-zero without
them. Phases, each of which raises on failure:

  1. build   — compiles the port's CUDA kernels from rsvio_tpu_torch/csrc/.
  2. kernel  — runs each kernel and its plain PyTorch version on the same
               CUDA tensors and requires equal ok on >= 99% of rows,
               |dpos| <= 1e-3 px and |dtheta| <= 1e-4 rad where both are
               ok; times both (CUDA events, median of 25: kernel_ms
               and plain_ms with the host's launch inside the interval,
               as in earlier runs; device_ms behind a GPU spin, the
               kernel's device work only):
               K1 klt_bidir at both main-path shapes (temporal pass:
               2 cameras x 256 slots; stereo match: 135 grid candidates)
               and at 2 cameras x 1024 slots, K1-rot
               klt_bidir(with_rotation) at the temporal shape on a pair
               whose second frame is rolled by 3 degrees, and K2 klt_level
               at pyramid levels 0 and 3, 512 features, translation and
               rotation. Each line gives the longest per-feature chain of
               dependent links (templates + Gauss-Newton steps, counted by
               the plain version) and the kernel's device time per link;
               K2's lines also the device time of the same launch with
               every feature dead (dead_ms: the kernel's fixed cost).
               K3 ba_assemble (the window solve's visual assembly) at the
               cells' shapes (W=10, L=256, sqrt-weights, euroc_vio.yaml's
               chi^2 gate on and off, float32; float64 checked, not timed)
               against its plain composition on the same CUDA tensors
               (2e-5 / 1e-12 of each output's largest magnitude; masks and
               counts equal), two launches bitwise equal; device_ms, ms,
               plain_ms and its bound (bytes in and out once, or its fp
               operations); its launches on the main and graph paths go
               into the kernels line.
  3. agree   — runs the port's estimator step on a small scene on the CPU
               (plain KLT) and on the GPU (kernels) and requires the poses
               to agree within 1e-3.
  4. track_points — ops.klt.track_points forward then backward (the
               JAX package's per-level composition) on the kernel route at
               the EuRoC shape, translation and rotation: exactly 2 x 6 K2
               launches per composition; each direction agrees with the
               same composition run through the plain klt_level_reference
               (so K2 is checked at every level and start this path gives
               it), and the whole with one fused K1 launch.
  5. main    — the port's make_estimator_step (eager) at the EuRoC shape
               (752x480, 6 levels, 256 slots, window 10, default
               EstimatorConfig) on the bench scene: 6 warm-up frames, 60
               timed frames, a 20-frame blocked quality pass and a 10-frame
               per-stage split. Requires exactly 2 K1 launches per frame
               and the bench.py quality floors (tracked_mean >= 80, kill
               rate <= 0.3, finite pose, pose_ok on every frame, BA fired
               in the quality pass, drift <= 2%).
  6. rotation — the same step with KLTConfig(track_rotation=True): 6 warm-up,
               30 timed and 20 quality frames, exactly 2 K1-rot launches per
               frame, the same floors.
  7. mono    — models.mono_tracker at the config/tartanair.yaml values on
               640x480 left-camera bench frames: exactly 1 K1 launch per
               frame after the first, tracked_mean >= 80, kill <= 0.3.
  8. configs — each shipped stereo VO config (config/euroc_vio.yaml in VO
               mode, euroc_vo_dynamic, euroc_vo_adaptive, 4seasons, tum_vi)
               through the port's load_config -> make_estimator_config ->
               make_estimator_step at its own widths (image shape, camera
               model and calibration, extrinsics, grid, capacity, levels,
               iterations, solver and tracker sections as in the file) on
               the bench plane rendered through its rig
               (bench_scene.render_rig). One override, printed:
               keyframe_management.translation_threshold is lowered to
               0.05 m where larger, or the window never fills in the frames
               run. 6 warm-up, 20 timed, 20 blocked and 10 split frames
               each (the per-stage split as in main); the floors of the
               main path (a config with a fixed PnP motion prior lags by
               design between keyframes and is held to drift <= 2% at the
               quality pass's last keyframe), exactly 2 K1 launches per
               frame, and for the adaptive config the RANSAC gate engaged
               and won on at least half of the frames after the window
               fills.
  9. options — the window options on the bench scene at full width, each
               run 6 warm-up, 20 timed, 20 blocked and 10 split frames:
               "marg" (the default config with use_marginalization, as
               --marginalization gives), "euroc_vo_dynamic+marg+cv" (that
               file with its commented marginalization and pnp_cv_predict
               keys switched on), "euroc_vo_adaptive+flow" (that file with
               dynamic_flow 0.02) and "window_opts" (the default config with
               refine_births, cull_reproj_threshold 0.02 and
               track_before_full=False). Each is held to the floors of main
               (a file with a fixed prior to those of configs; the cv run's
               drift is printed but not held: on this clean planar scene the
               constant-velocity seed closes the feedback loop the JAX
               package documents for it, rsvio_tpu/models/estimator.py:76-86,
               and the JAX step diverges alike on the same frames,
               tools/compare_vo_trajectories.py), to exactly 2
               K1 launches per frame, and to evidence that its options took
               effect (the step's probe counts: priors made and a valid
               prior at the end; constant-velocity seeds taken; tracks
               carrying a scene flow; landmarks refined and held to the cull
               threshold). Two CUDA-vs-CPU checks on fixed inputs:
               marginalize_oldest on the window system the marg run
               recorded (its last prior), H and g within 1e-4 of max|H|,
               and scene_flow_gate on tests/test_estimator.py's mover case
               (8 of 32 tracks displaced 0.03 a keyframe), equal kill sets.
 10. vio     — the VIO estimator (models/estimator_vio) at full width,
               three runs of 6 warm-up, 30 timed and 20 blocked frames and
               10 split frames, each on an IMU stream built on the host: a
               0.5 s static head at the start pose (fed to
               quasi_static_check and initialize_vio_state), then the
               motion at 200 Hz with constant biases (gyro 0.003 / -0.002
               / 0.004 rad/s, accel 0.02 / -0.015 / 0.01 m/s^2, the
               accuracy matrix's --imu-noise values) and white noise at the
               config's densities from a seeded numpy generator, bucketed
               per frame as the CLI does and uploaded by the step as one
               pinned copy a frame. "euroc_vio+vio": config/euroc_vio.yaml
               unmodified through make_estimator_config(kind="vio"),
               make_imu_params and the CLI's VIOBAConfig mapping, on the
               bench plane through the file's rig (render_rig) at 20 Hz;
               "depth_6dof+vio": data/synthetic's depth-structured scene
               flown on traj_6dof at 20 Hz, euroc_vio.yaml with its camera
               section replaced by the scene's pinhole rig (printed);
               "depth_6dof+vio+marg": the same with
               solver.marginalization true. Each is held to the stereo
               floors (drift: the last frame's position error over the
               path length so far, the main path's drift on the straight
               bench path) — but depth_6dof+vio's drift is printed, not
               held: the JAX step on its Pallas KLT route misses the 2 %
               on the same frames and IMU as the port does (2.37 % and
               2.40 % on the CPU; 0.35 % on its gather route, whose tracks
               differ by design; tools/compare_vo_trajectories.py --vio)
               —, the last frame's velocity within 0.1 m/s,
               exactly 2 K1 launches a frame, and the marg run to at least
               one prior made; it prints frames/s, the blocked median, the
               SE3-aligned ATE, the final biases beside the truth, and its
               keyframes' split (the ms of the step, of preintegrate and of
               the window solve).
 11. cli     — the dataset command lines in-process, on trees written
               into a temporary directory from bench frames quantized to
               uint8 (PNG rows cycling through all five filters):
               "euroc": 66 stereo frames through config/euroc_vio.yaml's
               rig at 752x480 as a mav0 tree (data.csv, an IMU csv, ground
               truth from bench_scene.truth_position), run_euroc.main with
               the shipped file unmodified and --trajectory-out, --eval-ate,
               --viewer-dir, --checkpoint-out, --quiet. Requires rc 0, no
               failed frame, 66 poses, the keyframe file's poses those of
               the keyframes, exactly 2 K1 launches a frame, the main
               path's floors, the trajectory within 1e-5 m / rad of the
               step driven directly over the same uint8 frames, the ATE
               <= 2 % of the path, statistics.txt, the PLY, the SVG and an
               overlay PNG written, and the checkpoint reloaded plus one
               step equal to the live state plus the same step. "tum" (30
               frames of config/tum_vi.yaml, 512x512 EUCM, 16-bit PNGs) and
               "4seasons" (30 frames of config/4seasons.yaml, 800x400,
               times.txt, GNSSPoses.txt), each from a copy of its file with
               the configs phase's printed keyframe override: rc 0, every
               frame processed, 2 K1 launches a frame. "euroc --vio": the
               euroc tree's IMU csv holds the euroc_vio+vio run's stream;
               run_euroc --vio on it, held to the VIO step driven directly
               on the same decoded frames and IMU buffers from the same
               bootstrap (within 1e-5 m / rad), 2 K1 launches a frame, the
               ATE printed. "tartanair": 40 left
               frames at 640x480 through run_tartanair.main with
               config/tartanair.yaml: 39 K1 launches and the mono floors.
               "--viewer": run_euroc on the euroc tree's first 30 frames
               and run_tartanair on its tree with the rerun viewer on a
               recording stand-in for the rerun SDK (put into sys.modules
               here; the SDK is not on the card's machine), each beside the
               same run without a viewer: the trajectory file byte for byte
               (tartanair: the tracked / alive counts), the same K1
               launches, the reference entity schema on every frame
               (stereo/left, stereo/right with their features,
               pose_current, pose_<i>, map/points, trajectory/path; the
               mono tracker's debug surface: labels, pyramid levels, the
               corner-score map), and both runs' ms a frame.
               Each cli[...] line gives the CLI's mean ms a frame (upload,
               step and its one read), the direct step's blocked median at
               the same config in this call, and the decode ms per frame
               on the prefetch thread.
 12. dist    — the distributed layer (rsvio_tpu_torch/parallel) in ranks
               spawned by parallel.dryrun.run_ranks (a file store),
               twice: NCCL at one rank per card, then gloo at 2 ranks on
               card 0 (CUDA tensors staged through the host). Each rank:
               the cost of one collective (the packed all-reduce of a
               solve's Schur system and a bare all-reduce); the four
               sharded window solvers on W=10 windows (dryrun's
               window_problem and vio_window_problem) at L=256 and 1024
               against the single-device solves on the same card (poses
               within 1e-3 relative + 1e-4, priors' H within 5e-3 of
               max|H|), their all-reduce calls and bytes a solve and an
               LM iteration (a 20-iteration solve less a 10-iteration
               one), which must not change with L; then 30 frames of the
               distributed VO step (the main path's default config, with
               and without use_marginalization) and of the distributed
               VIO step (config/euroc_vio.yaml with --vio and
               marginalization on the vio phase's euroc scene and IMU
               stream), each frame synchronized, every window solve
               synchronized and timed, beside the single-device step on
               the same frames (run first by rank 0 alone; the gloo run
               reuses the NCCL run's records of it). Requires the
               floors of main (VIO: of the vio phase, velocity too), the
               poses within 5e-3 m (VO) and 1e-2 (VIO, the velocity too)
               of the single-device step's with equal keyframes (the
               tolerances of tests/test_dist_estimator.py), the ranks'
               poses bitwise equal, exactly 2 K1 launches a frame on every
               rank and a sharded solve fired; prints frames/s, the
               blocked median (keyframe frames and the others apart) and
               the median solve ms of both, and the all-reduce calls and
               bytes a solve. On the NCCL run the compiled distributed
               steps (parallel.dist_estimator.make_compiled_distributed_*:
               CUDA graphs with the solve's collectives captured) then run
               the same frames, every call after the first under
               torch.cuda.set_sync_debug_mode("error"), beside the eager
               distributed runs and the single-device compiled step (rank
               0, before them): positions (VIO: the velocity too) within
               1e-5 m of the eager distributed step's with equal
               keyframes, the poses and each frame's variant keys equal
               across ranks, the run's collective counts equal to the
               eager run's, one blocking read and exactly 2 K1 launches a
               frame; printed: frames/s and blocked medians, the device
               ms of segment K on solve frames (CUDA events around the
               variant's run in place), each variant's ms of first run and
               capture and the memory the graphs hold. On the gloo run
               the compiled makers must raise ValueError (gloo's
               collectives cannot be captured).
 13. eval    — the evaluation harness (utils.evaluation.
               run_synthetic_sequence, as tools/accuracy_matrix drives it)
               at the matrix's full-width geometry (752x480, 6 levels, cell
               50, margin 19, 256 slots, window 10) with its IMU noise and
               biases and its per-scene seed, 80 frames at 20 Hz a run (the
               matrix runs 160: cut for the phase's time): depth_6dof x
               vo_fifo, held to tracked_mean >= 80, a BA success rate of 1
               and drift <= 2 %; occlusion_6dof (a textured quad moving
               2 m ahead of the rig) x vo_adapt, held to the RANSAC gate
               cutting tracks (inliers < candidates) on at least one frame
               and the track health dropping below 1 (the share of frames
               with the gate cutting printed); occlusion_6dof x
               vio_adapt, held to the scene-flow gate tracking or killing
               at least one track. Every run: exactly 2 K1 launches a
               frame and every pose finite; ATE, drift and frames/s
               printed, not held on the occlusion runs (the transit's
               outcome swings with the IMU-noise seed and the profile in
               the JAX package itself, tools/accuracy_matrix.py:55-72).
               These runs pass the probe, so the harness drives the eager
               step; each is repeated without it, through the compiled
               step (the harness's default), held to positions within
               1e-5 m of the eager run and 2 K1 launches a frame, its
               frames/s printed beside the eager run's.
 14. graph   — runs right after phase 10 (vio), repeating the eager
               runs of phases 5-10: models.estimator.
               make_compiled_estimator_step (the step as CUDA graphs of its
               segments, the counterpart of jax.jit(step)) on the frames,
               rig and config of main (6 warm-up frames, which capture the
               variants met by then, 60 timed, 20 blocked), rotation, each
               shipped config and the options phase's marg run (6 warm-up,
               20 timed, 20 blocked each); models.estimator_vio.
               make_compiled_vio_estimator_step on the vio phase's three
               runs (their frames, IMU buffers as host arrays and
               bootstrap; 6 warm-up, 30 timed, 20 blocked); and
               models.mono_tracker.make_compiled_mono_step on the mono
               phase's 40 frames (each blocked). Every VO / VIO call after
               the first and every mono call runs under
               torch.cuda.set_sync_debug_mode("error"). Each VO / VIO run
               is held to the floors of its eager run (VIO: the velocity
               too), its positions within 1e-5 m of the eager step's on
               the same frames, exactly 2 K1 (K1-rot) launches a frame and
               one blocking read a frame (the step's wait for is_kf); the
               mono run to the eager run's tracked / alive counts every
               frame, its last table (alive and ids equal, positions within
               1e-3 px), 39 K1 launches and no blocking read. Each prints
               frames/s (mono: the blocked median ms) and the blocked
               median beside the eager run's (VIO: also keyframe frames'
               and other frames' apart), the graphs made, each variant's
               ms of first run and capture, the captures inside the timed
               frames, VIO: the last 10 frames timed in place segment by
               segment (CUDA events around each segment's run: the device
               ms of F, P and K, the device's idle gaps between them and
               before / after them, the frame's wall ms; graph_split),
               each variant's runs, the growth of
               torch.cuda.memory_reserved over the run, each end measured
               after torch.cuda.empty_cache (the graphs' pools and
               buffers), and the device time of a replay alone of the
               frame-typical variants (CUDA events behind a GPU spin,
               median of 25; VO: segment M with PnP, K with and without a
               keyframe; VIO: the most used segment F and P (the
               keyframe stage's prologue, its interval loop), K with the
               solve and K without a keyframe; mono: the frame after the first,
               its previous pyramid copied back in before each replay);
               for main and each VIO run a one-replay torch.profiler count
               of device events (VIO: F, P and K with the solve). The cli
               phase's run_euroc (also --vio), run_tum, run_4seasons and
               run_tartanair runs go through the compiled steps too (the
               CLI takes them on CUDA), euroc and --vio under their checks
               against the eager step driven directly, tartanair against
               the eager mono step's counts on the same decoded frames.

 15. tools   — tools.bench_solvers (W=10, L=256, 20 LM iterations, 5 calls
               each) and tools.profile_components at 752x480, compiled
               (utils.graphs.compile_function: CUDA graphs, as the JAX
               tools time jitted functions) and with --eager in the same
               call; exactly 1 K1 launch a KLT call both ways; prints both
               and their ratios.
 16. gpu_tests — the gpu tests of tests/test_torch_gpu.py for the compiled
               distributed steps (NCCL at world size 1 in the test
               process), the compiled function and the compiled harness,
               in a pytest process of their own: all 7 cases pass.

Every path phase sets the launch counts to 0 just before it and reads them
just after. ``python3 chip_smoke.py --cli-ab`` instead runs only the build
and cli_ab (the euroc CLI against the direct step, in turns), and
``--dist-profile`` only the build and dist_profile (the sharded and the
single-device BA at one NCCL rank, timed in turns and profiled), and
``--dist-nccl`` only the build, parallel.dryrun.dryrun_multichip and the
dist phase's NCCL run at one rank per card on every card of the machine
(on a four-card machine the compiled distributed steps across four NCCL
ranks); none prints a result line. Drift is against the scene's truth, bench_scene.truth_position
(0.03 m a frame along the left camera's x axis). Prints the card's name and
power limit, per-phase numbers, a JSON line {"kernels": [...]} and, as the
last line, {"ok": true, "device": {...}}.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

WARMUP, TIMED, QUAL, SPLIT = 6, 60, 20, 10
ROT_TIMED = 30
CFG_TIMED = 20           # cut from 30 for the time of the tools and gpu_tests phases
OPT_TIMED = 20
CONFIGS = ("euroc_vio.yaml", "euroc_vo_dynamic.yaml", "euroc_vo_adaptive.yaml",
           "4seasons.yaml", "tum_vi.yaml")
KF_TRANSLATION_M = 0.05   # the bench's keyframe translation threshold
ROOT = os.path.dirname(os.path.abspath(__file__))
MONO_FRAMES, MONO_WARMUP = 40, 10
CLI_FRAMES = {"euroc": 66, "tum": 30, "4seasons": 30}
CLI_TOL = 1e-5          # m and rad: the CLI's trajectory vs the direct step
VIEWER_FRAMES = 30      # run_euroc --viewer and its plain twin (cli phase)
EUROC_T0 = 1_403_636_579_763_555_584   # ns, a EuRoC-like first stamp
VIO_TIMED = 30
VIO_FPS = 20.0
IMU_HZ = 200.0
VIO_SEED = 8
# Constant IMU biases of the vio runs (tools/accuracy_matrix.py --imu-noise).
VIO_BIAS_G = [0.003, -0.002, 0.004]      # rad/s
VIO_BIAS_A = [0.02, -0.015, 0.01]        # m/s^2
VIO_VEL_TOL = 0.1       # m/s, the last frame's velocity error
# vio runs whose drift floor the JAX step misses on the same frames (its
# Pallas KLT route, tools/compare_vo_trajectories.py --vio RUN --jax-pallas).
VIO_DRIFT_UNHELD = ("depth_6dof+vio",)
KERNEL_RUNS = 25
FUSION_CHAIN, FUSION_EPOCHS = 50, 4   # tools/bench_tracker_fusion's
SPIN_CYCLES = 2_000_000   # GPU spin ahead of each timed run (~1 ms)
POS_TOL = 1e-3
THETA_TOL = 1e-4
ROLL = 0.0524          # rad (3 degrees) between the K1-rot pair's frames
SOURCE = "rsvio_tpu_torch/csrc/klt_bidir.cu"
BA_SOURCE = "rsvio_tpu_torch/csrc/ba_assemble.cu"
BA_SHAPE = (10, 256)     # the cells' window and slots (euroc_vio.yaml)
BA_GATE = 0.01308        # euroc_vio.yaml's solver.chi2_gate
BA_REL = {"float32": 2e-5, "float64": 1e-12}   # tests/test_torch_gpu.py's
# fp operations of one observation, counted from csrc/ba_assemble.cu: its
# linearization (transforms, residual, Jacobians, Huber, weights) and one
# set's blocks (masking, H_pl, H_ll, g_l, the pose numbers, their sums).
BA_LIN_OPS, BA_SET_OPS = 223, 274
REPLACES = {
    "klt_bidir": "rsvio_tpu/ops/pallas/klt_kernel.py:737",
    "klt_bidir_rot": "rsvio_tpu/ops/pallas/klt_kernel.py:737",
    "klt_level": "rsvio_tpu/ops/pallas/klt_kernel.py:555",
}

# The mono tracker's settings, from config/tartanair.yaml (nlevels 5,
# ratio 2.0 with preprocessing_blur sigma 2.0, detection_min_dist 15 as the
# NMS radius and cell size, detection_threshold 2.5 in the reference's
# x1000 units -> 2.5 / 4000, optical_flow_max_iter 25,
# optical_flow_lm_lambda 0.1), mapped as rsvio_tpu/cli/run_tartanair.py
# maps them. The mono phase keeps them written in; the cli phase holds the
# port's mapping (cli/run_tartanair.tracker_settings) to them.
MONO = dict(levels=5, ratio=0.5, blur_sigma=2.0, radius=15,
            min_score=2.5 / 4000.0, max_iter=25, lm_lambda=0.1,
            capacity=256, shape=(480, 640), fx=320.0)

# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the tensor cores
# and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per pattern point, counted from csrc/klt_bidir.cu: building
# one template (samples, gradients, normalization, Hessian, H^-1 J rows) and
# one Gauss-Newton step (sample, residual, increment sums), per variant.
TEMPLATE_OPS = {False: 68, True: 90}
ITER_OPS = {False: 19, True: 42}
PATTERN_POINTS = 256


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, runs=KERNEL_RUNS, warmup=3, spin=False):
    """Median over `runs` of the time between CUDA events recorded just
    before and just after fn(). On an idle stream the interval also holds
    the host's launch of fn's work. With `spin`, each run first holds the
    stream with a ~1 ms GPU spin, so the host enqueues the start event and
    fn's launches before the GPU reaches them: the interval holds the
    device's work only (for a function that syncs inside, as the plain
    versions do, the host time after its first sync too)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def reset_counts():
    from rsvio_tpu_torch.ops.cuda import klt_kernel as kk
    kk.klt_bidir.launches = 0
    kk.klt_bidir.rot_launches = 0
    kk.klt_level.launches = 0


def counts():
    from rsvio_tpu_torch.ops.cuda import klt_kernel as kk
    return {"klt_bidir": kk.klt_bidir.launches,
            "klt_bidir_rot": kk.klt_bidir.rot_launches,
            "klt_level": kk.klt_level.launches}


def bound_ms(tensors, work, rot):
    """Least time for the same work: the bytes the call must move at HBM
    rate — each image pixel its templates and Gauss-Newton steps read, once
    (the plain version's work["touched"] masks, float32), plus the
    per-feature inputs and the outputs in `tensors` — or this run's
    operations at the fp32 rate, whichever is larger. Returns (ms, "bytes"
    or "operations", bytes)."""
    nbytes = 4 * sum(int(m.sum()) for m in work["touched"].values()) \
        + sum(t.numel() * t.element_size() for t in tensors)
    ops = PATTERN_POINTS * (work["templates"] * TEMPLATE_OPS[rot]
                            + work["iterations"] * ITER_OPS[rot])
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", nbytes
    return t_bytes, "bytes", nbytes


def compare(name, out, ref, n):
    """Kernel vs plain results: ok agreement, max |dpos|, max |dtheta|."""
    (pk, thk, okk), (pr, thr, okr) = out, ref
    agree = float((okk == okr).float().mean())
    both = okk & okr
    err = float((pk[both] - pr[both]).abs().max()) if bool(both.any()) \
        else 0.0
    err_th = float((thk[both] - thr[both]).abs().max()) if bool(both.any()) \
        else 0.0
    check(agree >= 0.99, f"{name}: ok agrees on only {agree:.4f}")
    check(err <= POS_TOL, f"{name}: max|dpos| {err} > {POS_TOL}")
    check(err_th <= THETA_TOL, f"{name}: max|dtheta| {err_th} > {THETA_TOL}")
    check(int(okk.sum()) >= n // 4, f"{name}: only {int(okk.sum())} ok")
    return agree, err, err_th


def chain_fields(device_ms, work):
    """The longest per-feature chain of the run (templates + Gauss-Newton
    steps, both directions, all levels; the plain version's work["chain"])
    and the kernel's device time per link of it."""
    max_chain = int(work["chain"].max())
    return {"max_chain": max_chain,
            "ns_per_link": device_ms * 1e6 / max(max_chain, 1)}


def k1_cases(frames, rolled, dev):
    """K1's inputs at the main-path shapes, by name: dicts of src, dst
    (packed pyramids), pos, alive, cam and rot. "temporal": the temporal
    pass, 2 cameras x 256 slots; "temporal2048": the same with 1024 slots
    per camera; "stereo": the stereo match of frame 11's left grid
    candidates; "temporal_rot": the temporal pass on a pair whose second
    frame is rolled by ROLL."""
    import torch
    from rsvio_tpu_torch.ops import detect, pyramid
    from rsvio_tpu_torch.ops.cuda import klt_kernel as kk

    (l0, r0), (l1, r1) = frames[10], frames[11]
    pyrs = [pyramid.build_pyramid(im, 6) for im in (l0, r0, l1, r1)]
    rot_pyrs = [pyramid.build_pyramid(im, 6) for im in rolled]
    gen = torch.Generator().manual_seed(0)
    src = kk.pack_pyramids([pyrs[0], pyrs[1]])
    dst = kk.pack_pyramids([pyrs[2], pyrs[3]])
    cases = {}
    for n in (256, 1024):
        # n slots per camera, cam1 at the plane's disparity.
        p0 = torch.rand((n, 2), generator=gen) \
            * torch.tensor([700.0, 430.0]) + torch.tensor([25.0, 25.0])
        p1 = p0 - torch.tensor([458.0 * 0.11 / 5.0, 0.0])
        cases[f"temporal{2 * n}"] = dict(
            src=src, dst=dst, pos=torch.cat([p0, p1]).to(dev),
            alive=torch.ones(2 * n, dtype=torch.bool, device=dev),
            cam=torch.cat([torch.zeros(n), torch.ones(n)]).to(
                torch.int32).to(dev), rot=False)
    cases["temporal"] = cases.pop("temporal512")
    cases["temporal_rot"] = dict(cases["temporal"],
                                 dst=kk.pack_pyramids(rot_pyrs), rot=True)
    score = detect.fast_score(l1)
    cand, cand_ok = detect.select_grid_features(
        score, torch.zeros((1, 2), device=dev),
        torch.zeros(1, dtype=torch.bool, device=dev), 50)
    cases["stereo"] = dict(
        src=kk.pack_pyramids([pyrs[2]]), dst=kk.pack_pyramids([pyrs[3]]),
        pos=cand.contiguous(), alive=cand_ok.contiguous(),
        cam=torch.zeros(cand.shape[0], dtype=torch.int32, device=dev),
        rot=False)
    return cases, pyrs, rot_pyrs


def kernel_phase(frames, rolled, dev):
    """Each kernel vs its plain version at the main-path shapes."""
    import torch
    from rsvio_tpu_torch.ops.cuda import klt_kernel as kk

    cases, pyrs, rot_pyrs = k1_cases(frames, rolled, dev)
    results = {}
    for name in ("temporal", "stereo", "temporal_rot", "temporal2048"):
        c = cases[name]
        (src, dims), (dst, _) = c["src"], c["dst"]
        args = (src, dst, dims, c["pos"], c["alive"], c["cam"])
        kw = dict(max_iterations=20, conv_thresh_sq=1e-4,
                  bidir_thresh_sq=0.4, coarse_tolerant=True,
                  with_rotation=c["rot"])
        out = kk.klt_bidir(*args, **kw)
        torch.cuda.synchronize()
        work = {"templates": 0, "iterations": 0}
        ref = kk.klt_bidir_reference(*args, work=work, **kw)
        n = c["pos"].shape[0]
        agree, err, err_th = compare(name, out, ref, n)
        ms = cuda_median_ms(lambda: kk.klt_bidir(*args, **kw))
        dev_ms = cuda_median_ms(lambda: kk.klt_bidir(*args, **kw), spin=True)
        plain_ms = cuda_median_ms(lambda: kk.klt_bidir_reference(*args, **kw))
        bms, by, nbytes = bound_ms(args[3:] + out, work, c["rot"])
        chain = chain_fields(dev_ms, work)
        print(f"kernel[{name}] C={src.shape[0]} N={n}: ok kernel="
              f"{int(out[2].sum())} plain={int(ref[2].sum())} agree="
              f"{agree:.4f} max|dpos|={err:.3g}px max|dth|={err_th:.3g} "
              f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={bms:.5f} ({by}; "
              f"{work['templates']} templates, "
              f"{work['iterations']} GN steps, {nbytes} B) max_chain="
              f"{chain['max_chain']} ns_per_link={chain['ns_per_link']:.1f}",
              flush=True)
        if c["rot"]:
            th_mean = float(out[1][out[2]].mean())
            print(f"kernel[{name}] mean theta of ok tracks {th_mean:.4f} rad "
                  f"(second frame rolled by {ROLL} rad)", flush=True)
            check(th_mean < -0.5 * ROLL, "the roll was not recovered")
        results[name] = dict(err=max(err, err_th), ms=ms, device_ms=dev_ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             **chain)

    # K2: one level, both variants, 512 features started 2.5 px (level 0
    # scale) off along the true motion.
    for lvl in (0, 3):
        s = 0.5 ** lvl
        src = torch.stack([pyrs[0][lvl], pyrs[1][lvl]]).contiguous()
        pos_src = (cases["temporal"]["pos"] * s).contiguous()
        start = (pos_src + torch.tensor([-2.5 * s, 0.0], device=dev)) \
            .contiguous()
        for rot in (False, True):
            dst_pyrs = rot_pyrs if rot else pyrs[2:]
            dst = torch.stack([dst_pyrs[0][lvl], dst_pyrs[1][lvl]]) \
                .contiguous()
            theta0 = torch.zeros(512, device=dev)
            args = (src, dst, pos_src, start, theta0,
                    cases["temporal"]["alive"], cases["temporal"]["cam"])
            kw = dict(max_iterations=20, conv_thresh_sq=1e-4,
                      with_rotation=rot)
            out = kk.klt_level(*args, **kw)
            torch.cuda.synchronize()
            work = {"templates": 0, "iterations": 0}
            ref = kk.klt_level_reference(*args, work=work, **kw)
            name = f"level{lvl}{'_rot' if rot else ''}"
            agree, err, err_th = compare(name, out, ref, 512)
            ms = cuda_median_ms(lambda: kk.klt_level(*args, **kw))
            dev_ms = cuda_median_ms(lambda: kk.klt_level(*args, **kw),
                                    spin=True)
            plain_ms = cuda_median_ms(
                lambda: kk.klt_level_reference(*args, **kw))
            # The same launch with every feature dead: no level stage, only
            # the per-feature reads and writes — the kernel's fixed cost.
            dead = args[:5] + (torch.zeros_like(args[5]), args[6])
            dead_ms = cuda_median_ms(lambda: kk.klt_level(*dead, **kw),
                                     spin=True)
            bms, by, nbytes = bound_ms(args[2:] + out, work, rot)
            chain = chain_fields(dev_ms, work)
            print(f"kernel[{name}] C=2 N=512 {tuple(src.shape[1:])}: ok "
                  f"kernel={int(out[2].sum())} plain={int(ref[2].sum())} "
                  f"agree={agree:.4f} max|dpos|={err:.3g}px max|dth|="
                  f"{err_th:.3g} kernel_ms={ms:.4f} device_ms={dev_ms:.4f} "
                  f"dead_ms={dead_ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bms:.5f} ({by}; {work['templates']} templates, "
                  f"{work['iterations']} GN steps, {nbytes} B) max_chain="
                  f"{chain['max_chain']} ns_per_link="
                  f"{chain['ns_per_link']:.1f}", flush=True)
            results[name] = dict(err=max(err, err_th), ms=ms,
                                 device_ms=dev_ms, dead_ms=dead_ms,
                                 plain_ms=plain_ms, bound_ms=bms,
                                 bound_by=by, **chain)
    return results


def ba_kernel_phase(dev):
    """K3 (ops.cuda.ba_kernel.ba_assemble) against its plain version at the
    cells' shapes, gate off and on (module docstring, phase 2)."""
    import torch
    from rsvio_tpu_torch.ops import lie
    from rsvio_tpu_torch.ops.cuda import ba_kernel as bk
    from rsvio_tpu_torch.parallel import dryrun

    W, L = BA_SHAPE
    results = {}
    for dtype in (torch.float32, torch.float64):
        T_W_B, T_C_B, lms, obs, mask, valid = dryrun.window_problem(
            W, L, seed=1, device=dev, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(1)
        obs = obs + 1e-3 * torch.randn(obs.shape, generator=gen, device=dev,
                                       dtype=dtype)
        obs[4, 1, :6] += 0.05
        w = 0.5 + torch.rand((W, L), generator=gen, device=dev, dtype=dtype)
        T_B_W = lie.se3_inverse(T_W_B)
        tname = str(dtype).split(".")[-1]
        for gate in (0.0, BA_GATE):
            args = (T_B_W, T_C_B, lms, obs, mask, w, valid, 2.0, gate)
            out = bk.ba_assemble(*args)
            again = bk.ba_assemble(*args)
            torch.cuda.synchronize()
            ref = bk.ba_assemble_reference(*args)
            pairs = list(zip(out.blocks, ref.blocks)) + [(out.r_sq, ref.r_sq)]
            if gate:
                pairs += list(zip(out.gated, ref.gated))
                for f in ("gate_mask", "gate_active", "n_obs", "n_active"):
                    check(torch.equal(getattr(out, f), getattr(ref, f)),
                          f"ba_assemble: {f} differs from the plain version")
            err = max(float((a - b).abs().max())
                      / max(float(b.abs().max()), 1e-30) for a, b in pairs)
            name = f"ba_assemble{'_gate' if gate else ''}_{tname}"
            check(err <= BA_REL[tname],
                  f"{name}: max relative error {err} > {BA_REL[tname]}")
            flat = [t for t in out if torch.is_tensor(t)] + \
                [t for b in (out.blocks, out.gated) if b for t in b]
            flat2 = [t for t in again if torch.is_tensor(t)] + \
                [t for b in (again.blocks, again.gated) if b for t in b]
            check(all(torch.equal(a, b) for a, b in zip(flat, flat2)),
                  f"{name}: two launches differ")
            row = dict(err=err)
            if dtype == torch.float32:
                sets = 2 if gate else 1
                ops = 2 * W * L * (BA_LIN_OPS + sets * BA_SET_OPS)
                nbytes = sum(t.numel() * t.element_size()
                             for t in (T_B_W, T_C_B, lms, obs, mask, w,
                                       valid, *flat))
                t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
                row.update(
                    ms=cuda_median_ms(lambda: bk.ba_assemble(*args)),
                    device_ms=cuda_median_ms(lambda: bk.ba_assemble(*args),
                                             spin=True),
                    plain_ms=cuda_median_ms(
                        lambda: bk.ba_assemble_reference(*args)),
                    bound_ms=max(t_b, t_o),
                    bound_by="bytes" if t_b >= t_o else "operations",
                    bytes=nbytes, ops=ops)
            print(f"kernel[{name}] W={W} L={L}: max_rel_err={err:.3g} "
                  + " ".join(f"{k}={v:.5g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in row.items()
                             if k != "err")
                  + (f" n_obs={int(out.n_obs)} n_active={int(out.n_active)}"
                     if gate else ""), flush=True)
            results[name] = row
    return results


def agree_phase(dev):
    """The port's step on a small scene, CPU (plain KLT) vs GPU (kernel)."""
    import torch
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator as est
    from rsvio_tpu_torch.models.frontend import FrontendConfig
    from rsvio_tpu_torch.ops.klt import KLTConfig

    shape = (96, 128)
    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=32, cell_size=24, detect_margin=10,
                                klt=KLTConfig(levels=3, max_iterations=8)),
        window_size=4, image_shape=shape)
    tex = bench_scene.make_texture(1, size=768,
                                   octaves=((90.0, 24), (60.0, 96)))
    kw = dict(shape=shape, fx=100.0, plane_z=4.0, scale=60.0, offset=200.0)
    frames = bench_scene.stereo_frames(tex, 10, step_m=0.02, **kw)
    step = est.make_estimator_step(cfg)
    worst = 0.0
    for d in (torch.device("cpu"), dev):
        rig = bench_scene.make_rig(d, shape=shape, fx=100.0)
        state = est.init_state(cfg, device=d)
        poses = []
        for a, b in frames:
            state, out = step(state, rig, a.to(d), b.to(d))
            poses.append(out.T_W_B.cpu())
        if d.type == "cpu":
            ref = poses
        else:
            worst = max(float((p - q).abs().max()) for p, q in zip(poses, ref))
    print(f"agree: small scene CPU vs GPU max|dT|={worst:.3g} over "
          f"{len(frames)} frames", flush=True)
    check(worst <= 1e-3, f"CPU and GPU steps disagree: {worst}")
    check(float(ref[-1][0, 3]) > 0.1, "small scene did not move")


def track_points_phase(frames, rolled, dev):
    """track_points forward + backward on the kernel route, at the EuRoC
    shape, both variants: each direction vs the same composition with the
    plain klt_level_reference at every level (the K2 check at every shape
    this path gives it), and the whole vs one fused bidirectional launch."""
    import torch
    from rsvio_tpu_torch.ops import klt, pyramid
    from rsvio_tpu_torch.ops.cuda import klt_kernel as kk

    gen = torch.Generator().manual_seed(1)
    pos = (torch.rand((256, 2), generator=gen) * torch.tensor([700.0, 430.0])
           + torch.tensor([25.0, 25.0])).to(dev)
    alive = torch.ones(256, dtype=torch.bool, device=dev)
    eye = torch.eye(2, device=dev).expand(256, 2, 2)
    p_src = pyramid.build_pyramid(frames[10][0], 6)
    level_launches = []
    for rot in (False, True):
        p_dst = pyramid.build_pyramid(rolled[0] if rot else frames[11][0], 6)
        cfg = klt.KLTConfig(track_rotation=rot)
        reset_counts()
        pf, Af, okf = klt.track_points(p_src, p_dst, pos, pos, eye, alive,
                                       cfg)
        pb, Ab, okb = klt.track_points(p_dst, p_src, pf, pos,
                                       Af.transpose(-1, -2), okf, cfg)
        torch.cuda.synchronize()
        c = counts()
        name = f"track_points{'_rot' if rot else ''}"
        check(c["klt_level"] == 12 and c["klt_bidir"] == 0
              and c["klt_bidir_rot"] == 0,
              f"{name}: launches {c}, want 12 of klt_level only")
        rf = klt._track_points_kernel(p_src, p_dst, pos, pos, eye, alive,
                                      cfg, level_fn=kk.klt_level_reference)
        rb = klt._track_points_kernel(p_dst, p_src, rf[0], pos,
                                      rf[1].transpose(-1, -2), rf[2], cfg,
                                      level_fn=kk.klt_level_reference)
        check(counts() == c, f"{name}: the plain composition launched")
        for d, out, ref in (("fwd", (pf, Af, okf), rf),
                            ("bwd", (pb, Ab, okb), rb)):
            th_o, th_r = (torch.atan2(A[:, 1, 0], A[:, 0, 0])
                          for A in (out[1], ref[1]))
            agree, err, err_th = compare(
                f"{name}[{d}] kernel vs plain", (out[0], th_o, out[2]),
                (ref[0], th_r, ref[2]), 256)
            print(f"{name}[{d}]: 6 K2 launches vs klt_level_reference at "
                  f"each level: ok kernel={int(out[2].sum())} plain="
                  f"{int(ref[2].sum())} agree={agree:.4f} max|dpos|="
                  f"{err:.3g}px max|dth|={err_th:.3g}", flush=True)
        ok = okf & okb & (((pb - pos) ** 2).sum(dim=1)
                          < cfg.bidir_threshold_sq)
        p1, A1, ok1 = klt.track_points_bidirectional(p_src, p_dst, pos,
                                                     alive, cfg)
        torch.cuda.synchronize()
        th, th1 = (torch.atan2(A[:, 1, 0], A[:, 0, 0]) for A in (Af, A1))
        agree, err, err_th = compare(name, (p1, th1, ok1), (pf, th, ok), 256)
        print(f"{name}: K2 launches {c['klt_level']} (fused K1: 1); ok "
              f"composed={int(ok.sum())} fused={int(ok1.sum())} agree="
              f"{agree:.4f} max|dpos|={err:.3g}px max|dth|={err_th:.3g}",
              flush=True)
        level_launches.append(c["klt_level"])
    return sum(level_launches), fusion_ab(dev)


def fusion_ab(dev):
    """tools.bench_tracker_fusion at its full size (752x480, 256 points, 6
    levels): the fused pass (1 K1 launch) against the composition (12 K2
    launches and the gate), chains of FUSION_CHAIN passes in FUSION_EPOCHS
    interleaved epochs; both routes' ms a pass, their ratio, launches and
    host syncs a pass, and survivors. Returns (klt_bidir's fields of the
    kernels line, the launch counts of the A/B)."""
    from rsvio_tpu_torch.tools import bench_tracker_fusion as bf

    reset_counts()
    r = bf.run(dev, FUSION_CHAIN, FUSION_EPOCHS)
    c = counts()
    f, k = r["fused"], r["composed"]
    check(f["launches"] == {"klt_bidir": 1, "klt_level": 0}
          and k["launches"] == {"klt_bidir": 0, "klt_level": 2 * bf.LEVELS},
          f"fusion_ab: launches a pass {f['launches']} / {k['launches']}")
    check(abs(f["survivors"] - k["survivors"]) <= 0.01 * bf.N
          and f["survivors"] >= 0.9 * bf.N,
          f"fusion_ab: survivors fused {f['survivors']} composed "
          f"{k['survivors']} of {bf.N}")
    line = {"fused_ms": f["best_ms"], "composed_ms": k["best_ms"],
            "composed_over_fused": k["best_ms"] / f["best_ms"],
            "fused_ms_all": f["ms"], "composed_ms_all": k["ms"],
            "fused_syncs_per_pass": len(f["syncs"]),
            "composed_syncs_per_pass": len(k["syncs"]),
            "sync_sites": sorted(set(f["syncs"] + k["syncs"])),
            "survivors_fused": f["survivors"],
            "survivors_composed": k["survivors"], "points": bf.N,
            "chain": FUSION_CHAIN, "epochs": FUSION_EPOCHS, "launches": c}
    print("fusion_ab: " + json.dumps(line), flush=True)
    return {"fusion_fused_ms": f["best_ms"],
            "fusion_composed_ms": k["best_ms"],
            "fusion_ratio": line["composed_over_fused"],
            "launches_fusion": c["klt_bidir"]}, c


class GraphWatch:
    """A compiled step's bookkeeping over a run (none for an eager step,
    `step` None): every call after the first under
    torch.cuda.set_sync_debug_mode("error"), so a host sync other than the
    step's one wait a frame raises; its blocking reads a frame from start()
    on; the variants captured between start() and stop() (the timed
    frames)."""

    def __init__(self, step):
        self.step = step
        self.reads0, self.caps = 0, [set(), set()]

    def start(self):
        if self.step is not None:
            self.reads0 = self.step.host_reads
            self.caps[0] = set(self.step.graphs.capture_ms)

    def stop(self):
        if self.step is not None:
            self.caps[1] = set(self.step.graphs.capture_ms)

    def call(self, k, step, *args):
        import torch
        if self.step is None or k == 0:
            return step(*args)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def fields(self, frames):
        """The summary's graph fields after `frames` calls (WARMUP of them
        before start())."""
        g = self.step.graphs
        return dict(
            host_reads_per_frame=(self.step.host_reads - self.reads0)
            / (frames - WARMUP),
            replays=g.replays,
            capture_ms={variant_name(k): v for k, v in g.capture_ms.items()},
            captures_in_timed={variant_name(k): g.capture_ms[k]
                               for k in self.caps[1] - self.caps[0]},
            uses={variant_name(k): v for k, v in g.uses.items()})


def run_vo(cfg, frames, rig, dev, timed, split_frames=0, probe=None,
           compiled=False):
    """Warm-up, timed and blocked quality frames of one estimator config;
    returns (summary dict, launch counts of the whole run, per-frame
    records of the warm-up, timed and quality frames: n_tracked,
    n_ransac_inliers, n_pnp_candidates, health, the window's fill before
    the frame, n_dyn_killed, is_keyframe and T_W_B, as numpy arrays). `probe`: a dict
    the step adds its option counts to (make_estimator_step). `compiled`:
    the step as CUDA graphs (make_compiled_estimator_step; no probe, no
    split), every call after the first under
    torch.cuda.set_sync_debug_mode("error"), so a host sync other than the
    step's one wait a frame raises; the summary adds the step's waits a
    frame after the first call, its replays and each variant's ms of first
    run and capture, the captures inside the timed frames and the runs of
    each variant (GraphWatch.fields), and the step comes back as a fourth
    result."""
    import numpy as np
    import torch
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator as est

    if compiled:
        pool0 = pool_bytes()
        step = est.make_compiled_estimator_step(cfg, device=dev)
    else:
        step = est.make_estimator_step(cfg, probe=probe)
    split = est.make_estimator_split_step(cfg, probe=probe)
    state = est.init_state(cfg, device=dev)
    rec, poses = [], []   # device tensors, read after the run
    watch = GraphWatch(step if compiled else None)

    def call(frame):
        return watch.call(len(rec), step, state, rig, *frame)

    def record(kf_before, out):
        rec.append(torch.stack([
            out.n_tracked.double(), out.n_ransac_inliers.double(),
            out.n_pnp_candidates.double(), out.health.double(),
            kf_before.double(), out.n_dyn_killed.double(),
            out.is_keyframe.double()]))
        poses.append(out.T_W_B.clone())

    reset_counts()
    k = 0
    for _ in range(WARMUP):
        kf_before = state.kf_count
        state, out = call(frames[k])
        record(kf_before, out)
        k += 1
    torch.cuda.synchronize()
    watch.start()
    t0 = time.perf_counter()
    for _ in range(timed):
        kf_before = state.kf_count
        state, out = call(frames[k])
        record(kf_before, out)
        k += 1
    torch.cuda.synchronize()
    fps = timed / (time.perf_counter() - t0)
    watch.stop()

    def drift_at(frame, T_W_B):
        t = T_W_B[:3, 3].double().cpu()
        truth = bench_scene.truth_position(rig, frame).double().cpu()
        return t, truth, float(torch.linalg.vector_norm(t - truth) / max(
            float(torch.linalg.vector_norm(truth)), 1e-9))

    tracked, alive, step_ms = [], [], []
    ba_seen, pose_ok_all, drift_kf = 0, True, float("nan")
    for _ in range(QUAL):
        kf_before = state.kf_count
        t1 = time.perf_counter()
        state, out = call(frames[k])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        record(kf_before, out)
        k += 1
        tracked.append(int(out.n_tracked))
        alive.append(int(out.n_alive))
        ba_seen += int(out.ba_success)
        pose_ok_all = pose_ok_all and bool(out.pose_ok)
        if bool(out.is_keyframe):
            drift_kf = drift_at(k - 1, out.T_W_B)[2]
    kill = float(np.mean([1.0 - tracked[i] / max(alive[i - 1], 1)
                          for i in range(1, QUAL)]))
    t_final, t_truth, drift = drift_at(k - 1, out.T_W_B)
    per_frame = dict(zip(
        ("n_tracked", "n_ransac_inliers", "n_pnp_candidates", "health",
         "kf_before", "n_dyn_killed", "is_keyframe"),
        torch.stack(rec).cpu().numpy().T))
    per_frame["T_W_B"] = torch.stack(poses).double().cpu().numpy()

    stage_ms = {name: [] for name in est.STAGE_NAMES}
    for _ in range(split_frames):
        state, out, times = split(state, rig, *frames[k])
        k += 1
        for name, v in times.items():
            stage_ms[name].append(v)
    c = counts()
    summary = {
        "frames_per_s": fps, "blocked_median_ms": statistics.median(step_ms),
        "tracked_mean": float(np.mean(tracked)), "bidir_kill_rate": kill,
        "t_final": t_final.tolist(), "t_truth": t_truth.tolist(),
        "drift_rel": drift, "drift_rel_last_kf": drift_kf,
        "ba_fires_in_quality_pass": ba_seen,
        "pose_ok": pose_ok_all, "frames": k, "launches": c,
        "marg_prior_valid": bool(state.marg_prior.valid)}
    if split_frames:
        summary["stage_median_ms"] = {n: statistics.median(v)
                                      for n, v in stage_ms.items()}
    if compiled:
        summary.update(watch.fields(k), pool_bytes=pool_bytes() - pool0)
        return summary, c, per_frame, step
    return summary, c, per_frame


def check_floors(tag, s, drift_key="drift_rel"):
    """The main path's floors; drift_key None holds no drift."""
    check(s["tracked_mean"] >= 80.0, f"{tag}: tracked_mean < 80")
    check(s["bidir_kill_rate"] <= 0.3,
          f"{tag}: kill rate {s['bidir_kill_rate']} > 0.3")
    check(all(v == v and abs(v) < 1e6 for v in s["t_final"]),
          f"{tag}: final pose not finite")
    check(s["pose_ok"], f"{tag}: pose recovery fired in the quality pass")
    check(s["ba_fires_in_quality_pass"] >= 1,
          f"{tag}: BA never fired in the quality pass")
    if drift_key is not None:
        check(s[drift_key] <= 0.02,
              f"{tag}: {drift_key} {s[drift_key]} > 0.02")


def main_phase(frames, dev):
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator as est

    cfg = est.EstimatorConfig()
    fe = cfg.frontend
    check((fe.capacity, fe.cell_size, fe.detect_margin, fe.klt.levels,
           fe.klt.max_iterations, cfg.window_size, tuple(cfg.image_shape))
          == (256, 50, 19, 6, 20, 10, (480, 752)),
          "default config is not the EuRoC bench shape")
    rig = bench_scene.make_rig(dev)
    s, c, pf = run_vo(cfg, frames, rig, dev, TIMED, split_frames=SPLIT)
    EAGER["main"] = (cfg, rig, frames, TIMED, s, pf)
    print("main: " + json.dumps(s), flush=True)
    check(c == {"klt_bidir": 2 * s["frames"], "klt_bidir_rot": 0,
                "klt_level": 0},
          f"main: launches {c} for {s['frames']} frames")
    check_floors("main", s)
    return c["klt_bidir"]


def rotation_phase(frames, dev):
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator as est
    from rsvio_tpu_torch.models.frontend import FrontendConfig
    from rsvio_tpu_torch.ops.klt import KLTConfig

    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(klt=KLTConfig(track_rotation=True)))
    rig = bench_scene.make_rig(dev)
    s, c, pf = run_vo(cfg, frames, rig, dev, ROT_TIMED)
    EAGER["rotation"] = (cfg, rig, frames, ROT_TIMED, s, pf)
    print("rotation: " + json.dumps(s), flush=True)
    check(c == {"klt_bidir": 0, "klt_bidir_rot": 2 * s["frames"],
                "klt_level": 0},
          f"rotation: launches {c} for {s['frames']} frames")
    check_floors("rotation", s)
    return c["klt_bidir_rot"]


# The eager runs the graph phase replays through the compiled step, by name:
# (config, rig, frames, timed frames, summary, per-frame records).
EAGER = {}
GRAPH_RUNS = ("main", "rotation", *CONFIGS, "marg")
GRAPH_POSE_TOL = 1e-5   # m: the compiled step's poses vs the eager step's
# The variants timed alone: M with PnP, K with the solve, K without a
# keyframe (utils.graphs keys of CompiledStep).
GRAPH_TIMED = (("motion", True), ("opt", True, True), ("opt", False, False))
# The vio phase's runs the graph phase replays through the compiled VIO step.
GRAPH_VIO_RUNS = ("euroc_vio+vio", "depth_6dof+vio", "depth_6dof+vio+marg")


def graph_phase(dev):
    """The compiled step (make_compiled_estimator_step, CUDA graphs) on the
    eager runs of main, rotation, each shipped config and marg (module
    docstring, phase 14); returns the launch counts of all its runs."""
    import numpy as np

    total = {"klt_bidir": 0, "klt_bidir_rot": 0, "klt_level": 0}
    for name in GRAPH_RUNS:
        t0 = time.perf_counter()
        cfg, rig, frames, timed, se, pfe = EAGER[name]
        s, c, pf, step = run_vo(cfg, frames, rig, dev, timed, compiled=True)
        n = s["frames"]
        gap = float(np.abs(pf["T_W_B"][:, :3, 3]
                           - pfe["T_W_B"][:n, :3, 3]).max())
        kernel = ("klt_bidir_rot" if cfg.frontend.klt.track_rotation
                  else "klt_bidir")
        drift_key = drift_key_of(cfg)
        line = {k: s[k] for k in (
            "frames_per_s", "blocked_median_ms", "tracked_mean",
            "bidir_kill_rate", "drift_rel", "drift_rel_last_kf",
            "host_reads_per_frame", "replays", "capture_ms",
            "captures_in_timed", "pool_bytes")}
        # Each frame-typical variant's replay alone (the graphs read and
        # write only the step's fixed buffers, so replays repeat the last
        # frame's work), behind a GPU spin: device time only.
        keys = [k for k in GRAPH_TIMED if k in step.graphs.graphs]
        line["device_ms"] = {
            variant_name(key): cuda_median_ms(
                lambda key=key: step.graphs.run(key, None), spin=True)
            for key in keys}
        if len(keys) == len(GRAPH_TIMED):
            # The timed frames' device time from the variants', and its
            # share of their wall time.
            d = line["device_ms"]
            kf = float(pf["is_keyframe"][WARMUP:WARMUP + timed].mean())
            est = (d["motion/True"] + kf * d["opt/True/True"]
                   + (1.0 - kf) * d["opt/False/False"])
            line.update(kf_share_timed=kf, device_ms_per_frame=est,
                        device_share=est * s["frames_per_s"] / 1e3)
        if name == "main":
            line["profile"] = graph_profile(step, keys)
        line.update(
            eager_frames_per_s=se["frames_per_s"],
            eager_blocked_median_ms=se["blocked_median_ms"],
            speedup_fps=s["frames_per_s"] / se["frames_per_s"],
            graphs=len(s["capture_ms"]), max_pose_gap_m=gap,
            ba_fires=s["ba_fires_in_quality_pass"], pose_ok=s["pose_ok"],
            launches=c, frames=n, drift_checked=drift_key,
            seconds=time.perf_counter() - t0)
        print(f"graph[{name}]: " + json.dumps(line), flush=True)
        want = {"klt_bidir": 0, "klt_bidir_rot": 0, "klt_level": 0}
        want[kernel] = 2 * n
        check(c == want, f"graph[{name}]: launches {c} for {n} frames")
        check(s["host_reads_per_frame"] == 1.0,
              f"graph[{name}]: {s['host_reads_per_frame']} blocking reads "
              f"a frame")
        check(gap <= GRAPH_POSE_TOL,
              f"graph[{name}]: poses {gap} m from the eager step's")
        check_floors(f"graph[{name}]", s, drift_key)
        for k in total:
            total[k] += c[k]
    for name in GRAPH_VIO_RUNS:
        c = graph_vio(name, dev)
        for k in total:
            total[k] += c[k]
    c = graph_mono(dev)
    for k in total:
        total[k] += c[k]
    return total


def typical_variants(graphs):
    """The most used variant of each kind of a compiled VIO step: segment F
    and segment P at their usual loop bounds, K with the window solve and K
    without a keyframe."""
    kinds = {("kf", True, True): "solve", ("kf", False): "none"}
    best = {}
    for key, n in graphs.uses.items():
        kind = {"front": "front", "kf_pre": "pre"}.get(key[0], kinds.get(key))
        if kind and n > graphs.uses.get(best.get(kind), 0):
            best[kind] = key
    return best


def pool_bytes():
    """torch.cuda.memory_reserved after releasing the allocator's unused
    cached blocks: the memory live tensors and CUDA graph pools hold."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def graph_vio(name, dev):
    """The compiled VIO step on the vio phase's eager run `name` (its
    frames, IMU buffers and bootstrap; module docstring, phase 14)."""
    import numpy as np

    t0 = time.perf_counter()
    vcfg, rig, frames, traj, se, re_ = EAGER[name]
    s, c, r, step = run_vio(vcfg, rig, frames, traj, dev, compiled=True)
    n = s["frames_all"]
    gap = float(np.abs(r[:, :3] - re_[:n, :3]).max())
    line = {k: s[k] for k in (
        "frames_per_s", "blocked_median_ms", "kf_blocked_median_ms",
        "non_kf_blocked_median_ms", "tracked_mean", "bidir_kill_rate",
        "drift_rel", "vel_err", "host_reads_per_frame", "replays",
        "capture_ms", "captures_in_timed", "pool_bytes", "uses", "split")}
    # The frame-typical variants' replays alone, behind a GPU spin (they
    # read the step's fixed buffers, so each repeats the last frame's work).
    typ = typical_variants(step.graphs)
    d = {kind: cuda_median_ms(lambda key=key: step.graphs.run(key, None),
                              spin=True) for kind, key in typ.items()}
    line["device_ms"] = {variant_name(typ[kind]): v for kind, v in d.items()}
    kf = float(r[WARMUP:WARMUP + VIO_TIMED, 7].mean())
    if len(d) == 4:
        kf_ms = d["front"] + d["pre"] + d["solve"]
        est = kf * kf_ms + (1.0 - kf) * (d["front"] + d["none"])
        line.update(kf_share_timed=kf, device_ms_per_frame=est,
                    device_ms_kf_frame=kf_ms,
                    device_share=est * s["frames_per_s"] / 1e3)
    line["profile"] = graph_profile(
        step, [typ[k] for k in ("front", "pre", "solve") if k in typ])
    drift_key = None if name in VIO_DRIFT_UNHELD else "drift_rel"
    line.update(
        eager_frames_per_s=se["frames_per_s"],
        eager_blocked_median_ms=se["blocked_median_ms"],
        eager_kf_blocked_median_ms=se["kf_blocked_median_ms"],
        speedup_fps=s["frames_per_s"] / se["frames_per_s"],
        graphs=len(s["capture_ms"]), max_pose_gap_m=gap,
        ba_fires=s["ba_fires_in_quality_pass"], pose_ok=s["pose_ok"],
        launches=c, frames=n, drift_checked=drift_key,
        seconds=time.perf_counter() - t0)
    print(f"graph[{name}]: " + json.dumps(line), flush=True)
    check(c == {"klt_bidir": 2 * n, "klt_bidir_rot": 0, "klt_level": 0},
          f"graph[{name}]: launches {c} for {n} frames")
    check(s["host_reads_per_frame"] == 1.0,
          f"graph[{name}]: {s['host_reads_per_frame']} blocking reads a "
          f"frame")
    check(gap <= GRAPH_POSE_TOL,
          f"graph[{name}]: poses {gap} m from the eager step's")
    check_floors(f"graph[{name}]", s, drift_key)
    check(s["vel_err"] <= VIO_VEL_TOL,
          f"graph[{name}]: velocity error {s['vel_err']} m/s")
    return c


def graph_mono(dev):
    """The compiled mono step on the mono phase's frames (module docstring,
    phase 14): the counts of every frame and the last table against the
    eager run's."""
    import numpy as np
    import torch
    from rsvio_tpu_torch.models import mono_tracker as mt

    t0 = time.perf_counter()
    cfg, make_pyramid, imgs, se, tracked_e, alive_e, table_e = EAGER["mono"]
    pool0 = pool_bytes()
    step = mt.make_compiled_mono_step(cfg, make_pyramid, device=dev)
    table = mt.init_mono_table(cfg.capacity, device=dev)
    watch = GraphWatch(step)
    stats_all, ms = [], []
    reset_counts()
    for k, img in enumerate(imgs):
        if k == MONO_WARMUP:
            watch.start()
        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            table, stats = step(table, img, first_frame=k == 0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        stats_all.append(torch.stack([stats["tracked"], stats["alive"]]))
    watch.stop()
    c = counts()
    tracked, alive = torch.stack(stats_all).cpu().numpy().T.tolist()
    same = ((table.alive == table_e.alive) & (table.fid == table_e.fid)) \
        .all()
    gap = float((table.pos - table_e.pos)[table_e.alive].abs().max())
    # The variant after the first frame replayed alone behind a GPU spin,
    # its previous pyramid copied back in first (the replay overwrites it).
    prev = make_pyramid(imgs[-2])
    key = ("mono", False)

    def replay():
        step._pyr.load(prev)
        step.graphs.run(key, None)
    line = {"frames": len(imgs), "ms_per_frame_median": statistics.median(
        ms[MONO_WARMUP:]), "eager_ms_per_frame_median":
        se["ms_per_frame_median"], "host_reads": step.host_reads,
        **{k: v for k, v in watch.fields(len(imgs)).items()
           if k != "host_reads_per_frame"},
        "pool_bytes": pool_bytes() - pool0,
        "device_ms": {variant_name(key): cuda_median_ms(replay, spin=True)},
        "counts_equal": (tracked, alive) == (tracked_e, alive_e),
        "table_equal": bool(same), "max_pos_gap_px": gap, "launches": c,
        "seconds": time.perf_counter() - t0}
    print("graph[mono]: " + json.dumps(line), flush=True)
    check(c == {"klt_bidir": len(imgs) - 1, "klt_bidir_rot": 0,
                "klt_level": 0},
          f"graph[mono]: launches {c} for {len(imgs)} frames")
    check(step.host_reads == 0, f"graph[mono]: {step.host_reads} reads")
    check(line["counts_equal"] and line["table_equal"],
          "graph[mono]: counts or table differ from the eager run's")
    check(gap <= POS_TOL, f"graph[mono]: positions {gap} px from eager")
    return c


def variant_name(key):
    return "/".join(str(x) for x in key)


def graph_profile(step, keys):
    """torch.profiler over one replay of each variant `keys` of the compiled
    step: its device events (kernels, copies), their summed device time,
    the mean per event and the largest one's share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for key in keys:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step.graphs.run(key, None)
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        us = [e.device_time_total for e in ev]
        total = sum(us)
        out[variant_name(key)] = {
            "device_events": len(ev), "device_ms": total / 1e3,
            "us_per_event": total / max(len(ev), 1),
            "largest_share": max(us) / total if total else None}
    return out


def mono_phase(tex, dev, medians):
    import numpy as np
    import torch
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import mono_tracker as mt
    from rsvio_tpu_torch.ops import pyramid
    from rsvio_tpu_torch.ops.klt import KLTConfig

    m = MONO
    cfg = mt.MonoTrackerConfig(
        capacity=m["capacity"], cell_size=m["radius"],
        min_score=m["min_score"], detect_mode="nms", nms_radius=m["radius"],
        klt=KLTConfig(levels=m["levels"], max_iterations=m["max_iter"],
                      convergence_threshold=0.005, lm_lambda=m["lm_lambda"],
                      pyramid_ratio=m["ratio"]))
    imgs = [bench_scene.render(tex, bench_scene.STEP_M * k, shape=m["shape"],
                               fx=m["fx"]) for k in range(MONO_FRAMES)]

    def make_pyramid(img):
        return pyramid.build_pyramid_ratio(img, m["levels"], m["ratio"],
                                           blur=True,
                                           blur_sigma=m["blur_sigma"])

    table = mt.init_mono_table(cfg.capacity, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    pyr_prev, tracked, alive, ms = None, [], [], []
    for k, img in enumerate(imgs):
        t0 = time.perf_counter()
        pyr = make_pyramid(img)
        table, stats = mt.mono_tracker_step(
            table, pyr if pyr_prev is None else pyr_prev, pyr, cfg,
            first_frame=pyr_prev is None)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        pyr_prev = pyr
        tracked.append(int(stats["tracked"]))
        alive.append(int(stats["alive"]))
    c = counts()
    q = range(MONO_WARMUP, MONO_FRAMES)
    kill = float(np.mean([1.0 - tracked[i] / max(alive[i - 1], 1)
                          for i in q]))
    s = {"frames": MONO_FRAMES, "ms_per_frame_median": statistics.median(
        ms[MONO_WARMUP:]), "tracked_mean": float(np.mean(
            [tracked[i] for i in q])), "kill_rate": kill,
         "alive_last": alive[-1], "launches": c}
    medians["mono"] = s["ms_per_frame_median"]
    EAGER["mono"] = (cfg, make_pyramid, imgs, s, tracked, alive,
                     mt.MonoTable(*(t.clone() for t in table)))
    print("mono: " + json.dumps(s), flush=True)
    check(c == {"klt_bidir": MONO_FRAMES - 1, "klt_bidir_rot": 0,
                "klt_level": 0},
          f"mono: launches {c} for {MONO_FRAMES} frames")
    check(s["tracked_mean"] >= 80.0, "mono: tracked_mean < 80")
    check(kill <= 0.3, f"mono: kill rate {kill} > 0.3")
    return c["klt_bidir"]


def shipped_config(name, tex, dev, **solver):
    """A shipped config file through load_config (with the `solver`
    section's keys set as given) -> make_estimator_config, and the bench
    plane rendered through its rig for a run of the configs phase's length.
    Returns (EstimatorConfig, rig, frames, override or None)."""
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.utils import config as config_mod

    cfg = config_mod.load_config(os.path.join(ROOT, "config", name))
    for k, v in solver.items():
        check(hasattr(cfg.solver, k), f"{name}: no solver key {k}")
        setattr(cfg.solver, k, v)
    km = cfg.keyframe_management
    override = None
    if km.translation_threshold > KF_TRANSLATION_M:
        override = (f"keyframe_management.translation_threshold "
                    f"{km.translation_threshold} -> {KF_TRANSLATION_M}")
        km.translation_threshold = KF_TRANSLATION_M
    ecfg, rig = config_mod.make_estimator_config(cfg, kind="vo", device=dev)
    kinds = (ecfg.cam_kind_l, ecfg.cam_kind_r)
    frames = [bench_scene.render_rig(tex, rig, kinds, k, ecfg.image_shape)
              for k in range(WARMUP + CFG_TIMED + QUAL + SPLIT)]
    return ecfg, rig, frames, override


def drift_key_of(ecfg):
    """A fixed PnP motion prior (pnp_motion_prior > 0 without
    pnp_prior_adaptive: euroc_vo_dynamic.yaml) holds each frame's pose near
    the previous one, so on this clean, moving scene the poses between
    keyframes lag the truth by design (the file's own TRADEOFF note; the JAX
    package lags alike, tests/test_torch_config.py::
    test_dynamic_profile_lags_in_jax_and_in_the_port) until a keyframe's
    BA, which has no prior, catches up. Such a config is held to 2 % at the
    last keyframe of the quality pass instead of at its last frame."""
    fixed_prior = (ecfg.pnp.motion_prior_weight > 0.0
                   and not ecfg.pnp_prior_adaptive)
    return "drift_rel_last_kf" if fixed_prior else "drift_rel"


def configs_phase(tex, dev, medians):
    """The shipped stereo VO configs end to end; returns the K1 launches of
    all of them and puts each config's blocked median ms in `medians`."""
    import numpy as np

    total = 0
    for name in CONFIGS:
        t0 = time.perf_counter()
        ecfg, rig, frames, override = shipped_config(name, tex, dev)
        kinds = (ecfg.cam_kind_l, ecfg.cam_kind_r)
        s, c, pf = run_vo(ecfg, frames, rig, dev, CFG_TIMED,
                          split_frames=SPLIT)
        EAGER[name] = (ecfg, rig, frames, CFG_TIMED, s, pf)
        fe = ecfg.frontend
        drift_key = drift_key_of(ecfg)
        line = {k: s[k] for k in (
            "frames_per_s", "blocked_median_ms", "tracked_mean",
            "bidir_kill_rate", "drift_rel", "drift_rel_last_kf")}
        line.update(
            ba_fires=s["ba_fires_in_quality_pass"], pose_ok=s["pose_ok"],
            launches=c, frames=s["frames"],
            image_shape=list(ecfg.image_shape), camera=kinds[0],
            floor_engaged_frames=int(
                (pf["n_tracked"] < fe.relax_floor_below).sum()),
            override=override, drift_checked=drift_key,
            stage_median_ms=s["stage_median_ms"])
        full = pf["kf_before"] >= ecfg.window_size
        if ecfg.pnp.ransac_hypotheses > 0:
            m = ecfg.pnp.ransac_min_inliers
            ransac_ok = ((pf["n_ransac_inliers"] >= m)
                         & (pf["n_pnp_candidates"] >= m))
            line["health_mean"] = float(np.mean(pf["health"]))
            line["ransac_ok_share_after_fill"] = float(
                ransac_ok[full].mean())
        line["seconds"] = time.perf_counter() - t0
        medians[name] = s["blocked_median_ms"]
        print(f"configs[{name}]: " + json.dumps(line), flush=True)
        check(c == {"klt_bidir": 2 * s["frames"], "klt_bidir_rot": 0,
                    "klt_level": 0},
              f"configs[{name}]: launches {c} for {s['frames']} frames")
        check_floors(f"configs[{name}]", s, drift_key)
        if ecfg.pnp.ransac_hypotheses > 0:
            check(full.any() and line["ransac_ok_share_after_fill"] >= 0.5,
                  f"configs[{name}]: the RANSAC gate won on only "
                  f"{line.get('ransac_ok_share_after_fill')} of the frames "
                  f"after the window filled")
        total += c["klt_bidir"]
    return total


def options_phase(tex, frames, dev):
    """The window options end to end (see the module docstring, phase 9)
    and the two CUDA-vs-CPU checks; returns the K1 launches of the runs."""
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator as est

    base = est.EstimatorConfig()
    runs = {
        "marg": lambda: (base._replace(use_marginalization=True),
                         bench_scene.make_rig(dev), frames, None),
        "euroc_vo_dynamic+marg+cv": lambda: shipped_config(
            "euroc_vo_dynamic.yaml", tex, dev, marginalization=True,
            pnp_cv_predict=True),
        "euroc_vo_adaptive+flow": lambda: shipped_config(
            "euroc_vo_adaptive.yaml", tex, dev, dynamic_flow=0.02),
        "window_opts": lambda: (base._replace(
            refine_births=True, cull_reproj_threshold=0.02,
            track_before_full=False), bench_scene.make_rig(dev), frames,
            None),
    }
    total = 0
    for name, make in runs.items():
        t0 = time.perf_counter()
        ecfg, rig, run_frames, override = make()
        probe = {}
        s, c, pf = run_vo(ecfg, run_frames, rig, dev, OPT_TIMED,
                          split_frames=SPLIT, probe=probe)
        if name in GRAPH_RUNS:
            EAGER[name] = (ecfg, rig, run_frames, OPT_TIMED, s, pf)
        probe = {k: int(v) for k, v in probe.items()}
        # The constant-velocity seed's feedback loop (module docstring,
        # phase 9): the reference diverges alike, so drift is not held.
        drift_key = None if ecfg.pnp_cv_predict else drift_key_of(ecfg)
        line = {k: s[k] for k in (
            "frames_per_s", "blocked_median_ms", "tracked_mean",
            "bidir_kill_rate", "drift_rel", "drift_rel_last_kf",
            "marg_prior_valid")}
        line.update(
            ba_fires=s["ba_fires_in_quality_pass"], pose_ok=s["pose_ok"],
            launches=c, frames=s["frames"],
            image_shape=list(ecfg.image_shape), override=override,
            drift_checked=drift_key, probe=probe,
            n_dyn_killed=int(pf["n_dyn_killed"].sum()),
            stage_median_ms=s["stage_median_ms"],
            seconds=time.perf_counter() - t0)
        print(f"options[{name}]: " + json.dumps(line), flush=True)
        check(c == {"klt_bidir": 2 * s["frames"], "klt_bidir_rot": 0,
                    "klt_level": 0},
              f"options[{name}]: launches {c} for {s['frames']} frames")
        check_floors(f"options[{name}]", s, drift_key)
        if ecfg.use_marginalization:
            check(probe["priors_made"] >= 2 and s["marg_prior_valid"],
                  f"options[{name}]: no marginalization prior in use")
        if ecfg.pnp_cv_predict:
            check(probe["cv_seeded"] > 0,
                  f"options[{name}]: no constant-velocity seed taken")
        if ecfg.dynamic_flow_thresh > 0:
            check(probe["flow_tracked"] > 0,
                  f"options[{name}]: the scene-flow gate tracked no flow")
        if ecfg.refine_births:
            check(probe["refined"] > 0 and probe["cull_checked"] > 0,
                  f"options[{name}]: no birth refined or cull check made")
        total += c["klt_bidir"]
    marg_agreement(dev)
    flow_agreement(dev)
    return total


def marg_agreement(dev):
    """marginalize_oldest on CUDA vs CPU on a recorded window system: the
    prior the default config with marginalization holds after 24 frames of
    the bench scene (its H, g and linearization point), marginalized once
    more. H and g within 1e-4 of max|H|."""
    import torch
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator as est
    from rsvio_tpu_torch.models import marginalization as marg

    cfg = est.EstimatorConfig(use_marginalization=True)
    tex = bench_scene.make_texture(0).to(dev)
    step = est.make_estimator_step(cfg)
    rig = bench_scene.make_rig(dev)
    state = est.init_state(cfg, device=dev)
    for a, b in bench_scene.stereo_frames(tex, 24):
        state, _ = step(state, rig, a, b)
    p = state.marg_prior
    check(bool(p.valid), "marg agreement: no prior after 24 frames")
    W = cfg.window_size
    args = (p.H, p.g, p.T0, p.x0_extra)
    cpu, gpu = (marg.marginalize_oldest(
        *(x.to(d) for x in args), marg.empty_prior(W, 6, device=d), 6)
        for d in (torch.device("cpu"), dev))
    scale = float(cpu.H.abs().max())
    err = max(float((gpu.H.cpu() - cpu.H).abs().max()),
              float((gpu.g.cpu() - cpu.g).abs().max()))
    print(f"options: marginalize_oldest CUDA vs CPU on the recorded window "
          f"system: max|dH|,|dg| = {err:.3g} (max|H| {scale:.4g})",
          flush=True)
    check(err <= 1e-4 * max(scale, 1.0) and bool(gpu.valid),
          f"marginalize_oldest disagrees: {err} vs max|H| {scale}")


def flow_agreement(dev):
    """scene_flow_gate on CUDA vs CPU on tests/test_estimator.py's mover
    case (32 points 2-6 m ahead, 8 displaced 0.03 z along x a keyframe, 4
    keyframes): identical kill sets, the 8 movers killed and no other."""
    import numpy as np
    import torch
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator as est

    n = 32
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(2.0, 6.0, n)], axis=1).astype(np.float32)
    mover = np.arange(n) < 8
    cfg = est.EstimatorConfig(dynamic_flow_thresh=0.02,
                              dynamic_flow_decay=0.7, dynamic_flow_min_n=2)
    killed = []
    for d in (torch.device("cpu"), dev):
        rig = bench_scene.make_rig(d, shape=(120, 160), fx=120.0)
        table = est.init_table(n, device=d)._replace(
            alive=torch.ones(n, dtype=torch.bool, device=d),
            fid=torch.arange(n, dtype=torch.int32, device=d))
        mem = (torch.from_numpy(pts).to(d), table.fid,
               torch.zeros((n, 2), device=d),
               torch.zeros(n, dtype=torch.int32, device=d))
        pts_k = pts.copy()
        kills = []
        for _ in range(4):
            pts_k[mover, 0] += 0.03 * pts_k[mover, 2]
            obs = np.stack([pts_k[:, :2] / pts_k[:, 2:3],
                            (pts_k[:, :2] - np.array([0.11, 0.0], np.float32))
                            / pts_k[:, 2:3]]).astype(np.float32)
            kill, mem, _ = est.scene_flow_gate(
                cfg, rig, torch.eye(4, device=d), torch.from_numpy(obs).to(d),
                torch.ones((2, n), dtype=torch.bool, device=d), table,
                torch.from_numpy(pts_k).to(d),
                torch.ones(n, dtype=torch.bool, device=d), *mem)
            kills.append(kill.cpu())
        killed.append(torch.stack(kills))
    same = torch.equal(killed[0], killed[1])
    any_kill = killed[1].any(dim=0).numpy()
    print(f"options: scene_flow_gate CUDA vs CPU on the mover case: kill "
          f"sets equal {same}, killed {int(any_kill.sum())} "
          f"(movers {int(mover.sum())})", flush=True)
    check(same, "scene_flow_gate kill sets differ between CUDA and CPU")
    check(bool((any_kill == mover).all()),
          "scene_flow_gate did not kill exactly the movers")


def vio_imu_stream(traj, n_frames, imu_params, seed=VIO_SEED,
                   t0_ns=EUROC_T0):
    """The host IMU stream of a VIO run: a 0.5 s static head at traj's
    start pose (the hold-still bootstrap of rsvio_tpu/utils/evaluation.py's
    static_init_imu) and the motion over frames 0..n_frames-1 at VIO_FPS,
    200 Hz, with the constant biases VIO_BIAS_G / VIO_BIAS_A and white noise
    at the config's densities from a seeded numpy generator. Returns
    {"ts" (ns, int64), "gyro", "accel"} and the head's sample count."""
    import numpy as np
    from rsvio_tpu_torch.data import synthetic

    rng = np.random.default_rng(seed)
    kw = dict(rate=IMU_HZ, gyro_bias=VIO_BIAS_G, accel_bias=VIO_BIAS_A,
              noise_rng=rng, gyro_noise=imu_params.gyro_noise,
              accel_noise=imu_params.accel_noise)
    hover = synthetic.Trajectory(pos_fn=lambda t: traj.pos_fn(0.0),
                                 ang_fn=lambda t: traj.ang_fn(0.0), R0=traj.R0)
    ts_h, g_h, a_h, _ = hover.sample_imu(-0.5, 0.0, **kw)
    ts_m, g_m, a_m, _ = traj.sample_imu(0.0, (n_frames - 1) / VIO_FPS, **kw)
    ts = np.concatenate([ts_h, ts_m])
    return ({"ts": t0_ns + np.round(ts * 1e9).astype(np.int64),
             "gyro": np.concatenate([g_h, g_m]),
             "accel": np.concatenate([a_h, a_m])}, len(ts_h))


def vio_imu_inputs(traj, n, imu_params):
    """(stream, head count, frame stamps (ns), per-frame host IMU buffers
    as the CLI builds them: the samples in (previous stamp, stamp])."""
    from rsvio_tpu_torch.cli import run as cli_run

    imu, n_head = vio_imu_stream(traj, n, imu_params)
    stamps_ns = [EUROC_T0 + int(round(k / VIO_FPS * 1e9)) for k in range(n)]
    bufs = [cli_run._imu_buffer_for_frame(
        imu, stamps_ns[k - 1] if k else None, stamps_ns[k])
        for k in range(n)]
    return imu, n_head, stamps_ns, bufs


def bench_trajectory(rig):
    """The bench plane's motion (bench_scene.truth_position: STEP_M a frame
    along the left camera's x axis, body attitude fixed) as a synthetic
    Trajectory at VIO_FPS, level in a z-up world."""
    import numpy as np
    from rsvio_tpu_torch.data import bench_scene, synthetic

    ex = rig.T_B_C[0, :3, 0].double().cpu().numpy()
    speed = bench_scene.STEP_M * VIO_FPS
    return synthetic.Trajectory(pos_fn=lambda t: speed * t * ex,
                                ang_fn=lambda t: np.zeros(3),
                                R0=np.eye(3))


def vio_runs(tex, dev):
    """name -> builder of (VIOEstimatorConfig, rig, frames (device
    tensors), Trajectory, override or None) for the vio phase's runs."""
    import numpy as np
    from rsvio_tpu_torch.cli import run as cli_run
    from rsvio_tpu_torch.data import bench_scene, synthetic
    from rsvio_tpu_torch.utils import config as config_mod

    n = WARMUP + VIO_TIMED + QUAL + SPLIT

    def euroc():
        cfg = config_mod.load_config(os.path.join(ROOT, "config",
                                                  "euroc_vio.yaml"))
        ecfg, rig = config_mod.make_estimator_config(cfg, kind="vio",
                                                     device=dev)
        kinds = (ecfg.cam_kind_l, ecfg.cam_kind_r)
        frames = [bench_scene.render_rig(tex, rig, kinds, k,
                                         ecfg.image_shape) for k in range(n)]
        return (cli_run.vio_config(cfg, ecfg), rig, frames,
                bench_trajectory(rig), None)

    def depth(marginalization):
        def build():
            cfg = config_mod.load_config(os.path.join(ROOT, "config",
                                                      "euroc_vio.yaml"))
            scene = synthetic.scene_depth_structured(device=dev)
            cam = cfg.camera
            cam.left_intrinsics = cam.right_intrinsics = [
                scene.fx, scene.fy, scene.cx, scene.cy]
            cam.left_distortion = cam.right_distortion = [0.0] * 4
            cam.T_B_Cl = np.eye(4).ravel().tolist()
            T_r = np.eye(4)
            T_r[0, 3] = scene.baseline
            cam.T_B_Cr = T_r.ravel().tolist()
            override = (f"camera -> the scene's pinhole rig (fx=fy="
                        f"{scene.fx}, cx={scene.cx}, cy={scene.cy}, no "
                        f"distortion, T_B_Cl = I, baseline {scene.baseline})")
            if marginalization:
                cfg.solver.marginalization = True
                override += ", solver.marginalization true"
            ecfg, rig = config_mod.make_estimator_config(cfg, kind="vio",
                                                         device=dev)
            traj = synthetic.traj_6dof()
            frames = [synthetic.render_stereo(scene, traj.pose(k / VIO_FPS),
                                              k / VIO_FPS)
                      for k in range(n)]
            return cli_run.vio_config(cfg, ecfg), rig, frames, traj, override
        return build

    return {"euroc_vio+vio": euroc, "depth_6dof+vio": depth(False),
            "depth_6dof+vio+marg": depth(True)}


def vio_velocity(traj, t, h=1e-5):
    return (traj.pos_fn(t + h) - traj.pos_fn(t - h)) / (2 * h)


def run_vio(vcfg, rig, frames, traj, dev, probe=None, compiled=False):
    """A VIO run: warm-up, timed and blocked quality frames on the frames'
    IMU buffers (built on the host beforehand as the CLI builds them, and
    uploaded by the step as one pinned copy a frame), from the
    gravity-aligned bootstrap on the stream's static head; then SPLIT
    frames with preintegrate and the window solve timed apart (a sync
    before and after each call). Returns (summary dict, launch counts of
    every frame, per-frame records (n, 8): position, n_tracked, n_alive,
    ba_success, pose_ok, is_keyframe). `compiled`: the step as CUDA graphs
    (make_compiled_vio_estimator_step; no probe, no split), every call
    after the first under torch.cuda.set_sync_debug_mode("error"); the
    summary adds GraphWatch.fields, the SPLIT frames' in-place segment
    times (graph_split) and the step comes back as a fourth result."""
    import torch
    from rsvio_tpu_torch.models import estimator_vio as ev

    n = len(frames)
    n_main = WARMUP + VIO_TIMED + QUAL
    imu, n_head, stamps_ns, bufs = vio_imu_inputs(traj, n, vcfg.imu_params)
    ok, info = ev.quasi_static_check(imu["gyro"][:n_head],
                                     imu["accel"][:n_head])
    check(ok, f"vio: the static head is not quasi-static: {info}")
    state = ev.initialize_vio_state(vcfg, imu["gyro"][:n_head],
                                    imu["accel"][:n_head], device=dev)
    pool0 = pool_bytes()
    if compiled:
        step = ev.make_compiled_vio_estimator_step(vcfg, device=dev)
    else:
        step = ev.make_vio_estimator_step(vcfg, probe=probe)
    rec, step_ms = [], []
    watch = GraphWatch(step if compiled else None)
    reset_counts()
    for k in range(n_main):
        if k == WARMUP:
            torch.cuda.synchronize()
            watch.start()
            t_timed = time.perf_counter()
        if k == WARMUP + VIO_TIMED:
            torch.cuda.synchronize()
            fps = VIO_TIMED / (time.perf_counter() - t_timed)
            watch.stop()
        t1 = time.perf_counter()
        state, out = watch.call(k, step, state, rig, *frames[k], *bufs[k])
        if k >= WARMUP + VIO_TIMED:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        rec.append(torch.cat([out.T_W_B[:3, 3].double(), torch.stack([
            out.n_tracked.double(), out.n_alive.double(),
            out.ba_success.double(), out.pose_ok.double(),
            out.is_keyframe.double()])]))
    r = torch.stack(rec).cpu().numpy()
    kf_q = r[WARMUP + VIO_TIMED:, 7] > 0.5
    s = {"frames_per_s": fps, "blocked_median_ms": statistics.median(step_ms),
         "kf_blocked_median_ms": statistics.median(
             [m for m, kf in zip(step_ms, kf_q) if kf] or [float("nan")]),
         "non_kf_blocked_median_ms": statistics.median(
             [m for m, kf in zip(step_ms, kf_q) if not kf]
             or [float("nan")]),
         **vio_metrics(r, traj, state.vel.double().cpu().numpy(),
                       vcfg.base.window_size),
         "bias_gyro": state.bg.double().cpu().numpy().tolist(),
         "bias_accel": state.ba.double().cpu().numpy().tolist(),
         "bias_truth": [VIO_BIAS_G, VIO_BIAS_A],
         "marg_prior_valid": bool(state.marg_prior.valid)}
    if compiled:
        c = counts()
        s.update(watch.fields(n_main), pool_bytes=pool_bytes() - pool0,
                 launches=c, frames_all=n_main)
        s["split"] = graph_split(step, state, rig, frames[n_main:],
                                 bufs[n_main:])
        return s, c, r, step
    s["split"] = vio_split(step, state, rig, frames[n_main:], bufs[n_main:])
    c = counts()
    s.update(launches=c, frames_all=n)
    return s, c, r


def vio_split(step, state, rig, frames, bufs):
    """Keyframes of `frames` split: the step's ms, and the ms of its
    preintegrate calls (the frame's samples and the interval's) and of its
    window solve, each call synchronized before and after."""
    import torch
    from rsvio_tpu_torch.models import estimator_vio as ev

    spent = {"preintegrate": 0.0, "solve": 0.0}

    def timed(fn, key):
        def f(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += (time.perf_counter() - t) * 1e3
            return out
        return f

    saved = (ev.imu_mod.preintegrate, ev.vio_ba.solve_vio_ba,
             ev.vio_ba.solve_vio_ba_marginalized)
    ev.imu_mod.preintegrate = timed(saved[0], "preintegrate")
    ev.vio_ba.solve_vio_ba = timed(saved[1], "solve")
    ev.vio_ba.solve_vio_ba_marginalized = timed(saved[2], "solve")
    kf = {"frame_ms": [], "preintegrate_ms": [], "solve_ms": []}
    other = []
    try:
        for (a, b), buf in zip(frames, bufs):
            spent.update(preintegrate=0.0, solve=0.0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, out = step(state, rig, a, b, *buf)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if bool(out.is_keyframe):
                kf["frame_ms"].append(ms)
                kf["preintegrate_ms"].append(spent["preintegrate"])
                kf["solve_ms"].append(spent["solve"])
            else:
                other.append((ms, spent["preintegrate"]))
    finally:
        (ev.imu_mod.preintegrate, ev.vio_ba.solve_vio_ba,
         ev.vio_ba.solve_vio_ba_marginalized) = saved
    out = {"keyframes": len(kf["frame_ms"]),
           **{f"kf_{k}_median": statistics.median(v) if v else None
              for k, v in kf.items()}}
    if other:
        out["non_kf_frame_ms_median"] = statistics.median(
            [m for m, _ in other])
        out["non_kf_preintegrate_ms_median"] = statistics.median(
            [p for _, p in other])
    return out


def graph_split(step, state, rig, frames, bufs):
    """Frames of a compiled VIO step timed in place, segment by segment:
    CUDA events around each variant's run give the device ms of segments F,
    P and K, the device's idle gaps between them (the host's wait for
    is_kf and its next launch) and before F / after K (the host's own work
    a frame: the step's prologue and epilogue); the frame's wall ms with a
    sync before and after. Medians over keyframe frames and the others;
    `captured` counts first uses among them (each an eager run and a
    capture, not a replay)."""
    import torch

    run = step.graphs.run
    marks = []

    def timed_run(key, fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        new = key not in step.graphs.graphs
        ev[0].record()
        run(key, fn)
        ev[1].record()
        marks.append((key[0], ev, new))

    rows = {"kf": [], "other": []}
    captured = 0
    step.graphs.run = timed_run
    try:
        for (a, b), buf in zip(frames, bufs):
            marks.clear()
            edge = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            edge[0].record()
            state, out = step(state, rig, a, b, *buf)
            edge[1].record()
            torch.cuda.synchronize()
            row = {"wall": (time.perf_counter() - t) * 1e3,
                   "before": edge[0].elapsed_time(marks[0][1][0]),
                   "after": marks[-1][1][1].elapsed_time(edge[1]),
                   "gaps": sum(marks[i][1][1].elapsed_time(marks[i + 1][1][0])
                               for i in range(len(marks) - 1))}
            for kind, ev, new in marks:
                row[{"front": "F", "kf_pre": "P", "kf": "K"}[kind]] = \
                    ev[0].elapsed_time(ev[1])
                captured += new
            rows["kf" if bool(out.is_keyframe) else "other"].append(row)
    finally:
        del step.graphs.run
    return {"captured": captured, **{
        f"{kind}_{f}_ms": statistics.median(r[f] for r in rs)
        for kind, rs in rows.items() if rs for f in rs[0]},
        "keyframes": len(rows["kf"]), "others": len(rows["other"])}


def vio_metrics(r, traj, v_est, window):
    """The floors' numbers of a VIO run from its per-frame records r (n, 8):
    position (3), n_tracked, n_alive, ba_success, pose_ok, is_keyframe.
    Drift is the last frame's position error over the path length so far
    (on the bench plane's straight path, the main path's definition); the
    ATE is SE3-aligned over every frame and over the frames after the
    window filled."""
    import numpy as np
    from rsvio_tpu_torch.utils import trajectory

    n = len(r)
    truth = np.stack([traj.pose(k / VIO_FPS)[:3, 3] for k in range(n)])
    path = float(np.linalg.norm(np.diff(truth, axis=0), axis=1).sum())
    pos = r[:, :3]
    q = range(n - QUAL, n)
    kill = float(np.mean([1.0 - r[i, 3] / max(r[i - 1, 4], 1) for i in q]))
    v_true = vio_velocity(traj, (n - 1) / VIO_FPS)
    kf = np.cumsum(r[:, 7])
    skip = int(np.nonzero(kf >= window)[0][0]) + 1 if kf[-1] >= window \
        else n // 3
    return {"tracked_mean": float(r[q, 3].mean()), "bidir_kill_rate": kill,
            "t_final": pos[-1].tolist(), "t_truth": truth[-1].tolist(),
            "drift_rel": float(np.linalg.norm(pos[-1] - truth[-1]) / path),
            "path_m": path, "ba_fires_in_quality_pass": int(r[q, 5].sum()),
            "pose_ok": bool(r[:, 6].all()),
            "vel_err": float(np.linalg.norm(v_est - v_true)),
            "vel": np.asarray(v_est).tolist(), "vel_truth": v_true.tolist(),
            "ate_m": float(trajectory.ate_rmse(pos, truth)[0]),
            "ate_post_fill_m": float(trajectory.ate_rmse(pos[skip:],
                                                          truth[skip:])[0]),
            "keyframes": int(kf[-1]), "frames": n}


def vio_phase(tex, dev):
    """The VIO estimator end to end (module docstring, phase 10); returns
    the K1 launches of its runs."""
    total = 0
    for name, build in vio_runs(tex, dev).items():
        t0 = time.perf_counter()
        vcfg, rig, frames, traj, override = build()
        probe = {}
        s, c, r = run_vio(vcfg, rig, frames, traj, dev, probe=probe)
        EAGER[name] = (vcfg, rig, frames, traj, s, r)
        s["probe"] = {k: int(v) for k, v in probe.items()}
        s["override"] = override
        s["seconds"] = time.perf_counter() - t0
        print(f"vio[{name}]: " + json.dumps(s), flush=True)
        check(c == {"klt_bidir": 2 * s["frames_all"], "klt_bidir_rot": 0,
                    "klt_level": 0},
              f"vio[{name}]: launches {c} for {s['frames_all']} frames")
        # A floor the JAX step misses on the same frames is printed, not
        # held (module docstring, phase 10).
        s["drift_checked"] = None if name in VIO_DRIFT_UNHELD else "drift_rel"
        check_floors(f"vio[{name}]", s, s["drift_checked"])
        check(s["vel_err"] <= VIO_VEL_TOL,
              f"vio[{name}]: velocity error {s['vel_err']} m/s > "
              f"{VIO_VEL_TOL}")
        if vcfg.base.use_marginalization:
            check(s["probe"].get("priors_made", 0) >= 1,
                  f"vio[{name}]: no marginalization prior made")
        total += c["klt_bidir"]
    return total


def quantize(img):
    """A rendered frame as the uint8 image a camera would record."""
    import torch
    return img.round().clamp(0, 255).to(torch.uint8).cpu().numpy()


def config_copy(name, tmp):
    """The shipped config `name`, or, where its keyframe translation
    threshold exceeds KF_TRANSLATION_M, a copy in `tmp` with the configs
    phase's override written in. Returns (path, override or None)."""
    from rsvio_tpu_torch.utils import config as config_mod

    path = os.path.join(ROOT, "config", name)
    thr = config_mod.load_config(path).keyframe_management \
        .translation_threshold
    if thr <= KF_TRANSLATION_M:
        return path, None
    with open(path) as f:
        text, n = re.subn(r"(\n\s*translation_threshold:\s*)[0-9.eE+-]+",
                          rf"\g<1>{KF_TRANSLATION_M}", f.read(), count=1)
    check(n == 1, f"{name}: no translation_threshold line")
    out = os.path.join(tmp, name)
    with open(out, "w") as f:
        f.write(text)
    check(config_mod.load_config(out).keyframe_management
          .translation_threshold == KF_TRANSLATION_M,
          f"{name}: the override did not take")
    return out, (f"keyframe_management.translation_threshold {thr} -> "
                 f"{KF_TRANSLATION_M}")


def cli_frames(tex, cfg_path, n, dev):
    """(EstimatorConfig, rig, n uint8 stereo frames rendered through the
    config's rig, (n, 3) truth positions)."""
    import numpy as np
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.utils import config as config_mod

    ecfg, rig = config_mod.make_estimator_config(
        config_mod.load_config(cfg_path), kind="vo", device=dev)
    kinds = (ecfg.cam_kind_l, ecfg.cam_kind_r)
    frames = [tuple(quantize(x) for x in bench_scene.render_rig(
        tex, rig, kinds, k, ecfg.image_shape)) for k in range(n)]
    truth = np.stack([bench_scene.truth_position(rig, k).double().cpu()
                      .numpy() for k in range(n)])
    return ecfg, rig, frames, truth


def stamps(n):
    return [EUROC_T0 + 50_000_000 * k for k in range(n)]


def quat_angle(qa, qb):
    """Angle (rad) between rotations given as quaternions, row by row."""
    import numpy as np
    qa = qa / np.linalg.norm(qa, axis=1, keepdims=True)
    qb = qb / np.linalg.norm(qb, axis=1, keepdims=True)
    d = np.minimum(np.linalg.norm(qa - qb, axis=1),
                   np.linalg.norm(qa + qb, axis=1))
    return 4.0 * np.arcsin(np.clip(d / 2.0, 0.0, 1.0))


def ms_stats(res):
    import numpy as np
    return {"cli_ms_per_frame": res.avg_processing_time_ms,
            "cli_ms_median": float(np.median(res.frame_processing_times_ms)),
            "decode_ms_per_frame": float(np.mean(res.decode_times_ms)),
            "n_failed": res.n_failed,
            "frames": len(res.frame_processing_times_ms)}


def direct_run(ecfg, rig, u8, dev):
    """The step driven directly over uint8 frames (uploaded before each
    frame's clock starts), blocked: (step, final state, poses, per-frame
    [n_tracked, n_alive, ba_success, pose_ok, is_keyframe], ms a frame)."""
    import numpy as np
    import torch
    from rsvio_tpu_torch.models import estimator as est

    step = est.make_estimator_step(ecfg)
    state = est.init_state(ecfg, device=dev)
    poses, rec, step_ms = [], [], []
    for a, b in u8:
        a, b = (torch.from_numpy(x).to(dev).float() for x in (a, b))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, out = step(state, rig, a, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        poses.append(out.T_W_B.double().cpu().numpy())
        rec.append([int(out.n_tracked), int(out.n_alive),
                    int(out.ba_success), int(out.pose_ok),
                    int(out.is_keyframe)])
    return step, state, poses, np.array(rec), step_ms


def cli_euroc(tex, dev, tmp):
    """run_euroc on a mav0 tree of config/euroc_vio.yaml's frames, checked
    against the step driven directly (module docstring, phase 11)."""
    import numpy as np
    import torch
    from rsvio_tpu_torch.cli import run_euroc
    from rsvio_tpu_torch.data import writers
    from rsvio_tpu_torch.models import estimator as est
    from rsvio_tpu_torch.utils import checkpoint, trajectory
    from rsvio_tpu_torch.utils import config as config_mod

    n = CLI_FRAMES["euroc"]
    cfg_path = os.path.join(ROOT, "config", "euroc_vio.yaml")
    ecfg, rig, u8, truth = cli_frames(tex, cfg_path, n + 1, dev)
    ts = stamps(n)
    imu, _ = vio_imu_stream(bench_trajectory(rig), n, config_mod.make_imu_params(
        config_mod.load_config(cfg_path)))
    imu_rows = np.concatenate([imu["ts"][:, None].astype(np.float64),
                               imu["gyro"], imu["accel"]], axis=1)
    root = writers.write_euroc(os.path.join(tmp, "euroc"), u8[:n], ts,
                               gt_positions=truth[:n], imu=imu_rows)
    traj, ckpt = os.path.join(tmp, "euroc.txt"), os.path.join(tmp, "s.ckpt")
    vdir = os.path.join(tmp, "viz")
    reset_counts()
    rc = run_euroc.main([cfg_path, root, "--trajectory-out", traj,
                         "--eval-ate", "--viewer-dir", vdir,
                         "--checkpoint-out", ckpt, "--quiet"])
    c = counts()
    res = run_euroc.main.last_result
    check(rc == 0 and res.n_failed == 0,
          f"cli[euroc]: rc {rc}, failed frames {res.n_failed}")
    check(c == {"klt_bidir": 2 * n, "klt_bidir_rot": 0, "klt_level": 0},
          f"cli[euroc]: launches {c} for {n} frames")

    step, state, poses, rec, step_ms = direct_run(ecfg, rig, u8[:n], dev)

    t_cli, pos_cli, q_cli = trajectory.load_tum(traj)
    check(len(t_cli) == n, f"cli[euroc]: {len(t_cli)} poses, want {n}")
    dpos = float(np.abs(pos_cli - np.stack([p[:3, 3] for p in poses])).max())
    drot = float(quat_angle(q_cli, np.stack(
        [trajectory.rot_to_quat_np(p[:3, :3]) for p in poses])).max())
    check(dpos <= CLI_TOL and drot <= CLI_TOL,
          f"cli[euroc]: trajectory vs direct step {dpos} m, {drot} rad")
    kf_ts = trajectory.load_tum(traj.replace(".txt", "_keyframes.txt"))[0]
    want_kf = np.asarray(ts, np.float64)[rec[:, 4] == 1] * 1e-9
    check(len(kf_ts) == int(rec[:, 4].sum()) >= 1
          and np.allclose(kf_ts, want_kf, atol=1e-6),
          f"cli[euroc]: {len(kf_ts)} keyframe poses, want "
          f"{int(rec[:, 4].sum())}")

    # The main path's floors over the last QUAL frames of the same run.
    q = range(n - QUAL, n)
    drift = float(np.linalg.norm(poses[-1][:3, 3] - truth[n - 1])
                  / np.linalg.norm(truth[n - 1]))
    s = {"tracked_mean": float(rec[q, 0].mean()),
         "bidir_kill_rate": float(np.mean(
             [1.0 - rec[i, 0] / max(rec[i - 1, 1], 1) for i in q])),
         "t_final": poses[-1][:3, 3].tolist(), "pose_ok": bool(
             rec[q, 3].all()),
         "ba_fires_in_quality_pass": int(rec[q, 2].sum()),
         "drift_rel": drift}
    check_floors("cli[euroc]", s)

    with open(os.path.join(root, "statistics.txt")) as f:
        stats = f.read()
    m = re.search(r"ate_rmse_m: (\S+)", stats)
    path_m = float(np.linalg.norm(np.diff(truth[:n], axis=0), axis=1).sum())
    check(m is not None, "cli[euroc]: no ATE in statistics.txt")
    ate = float(m.group(1))
    check(ate <= 0.02 * path_m, f"cli[euroc]: ATE {ate} m > 2 % of "
          f"{path_m} m")
    frames_dir = os.path.join(vdir, "frames")
    overlays = [f for f in os.listdir(frames_dir)
                if f.startswith("stereo_left")]
    check(os.path.exists(os.path.join(vdir, "map_points.ply"))
          and os.path.exists(os.path.join(vdir, "trajectory.svg"))
          and overlays, "cli[euroc]: viewer artifacts missing")

    # The checkpoint plus one step vs the live state plus the same step.
    a, b = (torch.from_numpy(x).to(dev).float() for x in u8[n])
    live, _ = step(state, rig, a, b)
    loaded = checkpoint.load_state(ckpt, est.init_state(ecfg, device=dev))
    resumed, _ = step(loaded, rig, a, b)
    worst = 0.0
    for (name, x), (_, y) in zip(checkpoint.flatten(resumed),
                                 checkpoint.flatten(live)):
        if x.dtype.is_floating_point:
            worst = max(worst, float((x - y).abs().max()
                                     / max(1.0, float(y.abs().max())))
                        if x.numel() else 0.0)
        else:
            check(torch.equal(x, y), f"cli[euroc]: resumed {name} differs")
    check(worst <= CLI_TOL, f"cli[euroc]: resumed state differs by {worst}")

    line = {**ms_stats(res), "direct_blocked_median_ms": statistics.median(
        step_ms), "launches": c, "poses": int(len(t_cli)),
        "keyframes": int(len(kf_ts)), "traj_vs_direct_m": dpos,
        "traj_vs_direct_rad": drot, "ate_m": ate, "path_m": path_m,
        "tracked_mean": s["tracked_mean"], "kill": s["bidir_kill_rate"],
        "drift_rel": drift, "ba_fires": s["ba_fires_in_quality_pass"],
        "overlays": len(overlays), "resume_max_rel_diff": worst}
    print("cli[euroc]: " + json.dumps(line), flush=True)
    return (c["klt_bidir"] + cli_euroc_viewer(cfg_path, root, tmp)
            + cli_euroc_vio(cfg_path, root, u8[:n], truth[:n], tmp))


def rerun_stub():
    """(module, calls): a recording stand-in for the rerun SDK, which the
    card's machine does not have. It takes every construction and call the
    port's RerunViewer makes; calls records ("init", app_id), ("frame", k)
    for each set_time_sequence and ("log", path, archetype) for each
    log."""
    import types

    calls = []

    class Archetype:
        def __init__(self, *a, **k):
            self.args, self.kwargs, self.jpeg = a, k, None

        def compress(self, jpeg_quality=75):
            self.jpeg = jpeg_quality
            return self

    rr = types.ModuleType("rerun")
    for name in ("Arrows3D", "Image", "Points2D", "Points3D", "Transform3D",
                 "Quaternion", "Pinhole", "LineStrips3D", "DepthImage"):
        setattr(rr, name, type(name, (Archetype,), {}))
    rr.ViewCoordinates = types.SimpleNamespace(RDF="RDF")
    rr.init = lambda app_id, spawn=True: calls.append(("init", app_id))
    rr.log = lambda path, obj, static=False: calls.append(("log", path, obj))
    rr.set_time_sequence = lambda name, k: calls.append(("frame", k))
    rr.set_time_seconds = lambda name, t: None
    return rr, calls


def viewer_run(main, argv):
    """main(argv + ["--viewer"]) with rerun_stub() as the rerun SDK: (rc,
    the entity paths logged after each frame's set_frame, the calls)."""
    rr, calls = rerun_stub()
    prev = sys.modules.get("rerun")
    sys.modules["rerun"] = rr
    try:
        rc = main(argv + ["--viewer"])
    finally:
        if prev is None:
            del sys.modules["rerun"]
        else:
            sys.modules["rerun"] = prev
    check(calls and calls[0] == ("init", "rsvio_tpu"),
          f"viewer: the rerun viewer did not start ({calls[:1]})")
    frames = []
    for c in calls:
        if c[0] == "frame":
            frames.append([])
        elif c[0] == "log" and frames:
            frames[-1].append(c[1])
    return rc, frames, calls


def cli_euroc_viewer(cfg_path, root, tmp):
    """run_euroc --viewer (the rerun viewer on the recording stub) over the
    first VIEWER_FRAMES frames of the euroc tree against the same run
    without a viewer: the trajectory file byte for byte, the reference
    entity schema every frame (estimator.rs:272-364), 2 K1 launches a
    frame, and both runs' ms a frame."""
    import numpy as np
    from rsvio_tpu_torch.cli import run_euroc

    n = VIEWER_FRAMES
    out = {k: os.path.join(tmp, f"viewer_{k}.txt")
           for k in ("plain", "viewer")}
    argv = [cfg_path, root, "--max-frames", str(n), "--quiet"]
    check(run_euroc.main(argv + ["--trajectory-out", out["plain"]]) == 0,
          "cli[euroc --viewer]: the plain run failed")
    plain = run_euroc.main.last_result.frame_processing_times_ms
    reset_counts()
    rc, frames, calls = viewer_run(run_euroc.main, argv + [
        "--trajectory-out", out["viewer"]])
    c = counts()
    shown = run_euroc.main.last_result.frame_processing_times_ms
    with open(out["plain"], "rb") as a, open(out["viewer"], "rb") as b:
        same = a.read() == b.read()
    check(rc == 0 and same, f"cli[euroc --viewer]: rc {rc}, trajectory "
          f"equal to the plain run's: {same}")
    check(c == {"klt_bidir": 2 * n, "klt_bidir_rot": 0, "klt_level": 0},
          f"cli[euroc --viewer]: launches {c} for {n} frames")
    check(len(frames) == n, f"cli[euroc --viewer]: {len(frames)} frames "
          f"logged, want {n}")
    need = {"stereo/left", "stereo/left/features", "stereo/right",
            "stereo/right/features", "pose_current", "pose_<i>"}
    for k, paths in enumerate(frames):
        kinds = {re.sub(r"^pose_\d+$", "pose_<i>", p) for p in paths}
        check(need <= kinds <= need | {"map/points", "trajectory/path"}
              and ("trajectory/path" in kinds) == (k > 0),
              f"cli[euroc --viewer]: frame {k} logged {sorted(kinds)}")
    check(any("map/points" in p for p in frames),
          "cli[euroc --viewer]: no map/points logged")
    jpeg = {call[2].jpeg for call in calls if call[0] == "log"
            and type(call[2]).__name__ == "Image"}
    check(jpeg == {75}, f"cli[euroc --viewer]: JPEG qualities {jpeg}")
    line = {"frames": n, "launches": c, "traj_bitwise_plain": same,
            "entities_last_frame": sorted(set(frames[-1])),
            "logs_per_frame": len(frames[-1]),
            "viewer_ms_median": float(np.median(shown)),
            "plain_ms_median": float(np.median(plain)),
            "viewer_ms_mean": float(np.mean(shown)),
            "plain_ms_mean": float(np.mean(plain))}
    print("cli[euroc --viewer]: " + json.dumps(line), flush=True)
    return c["klt_bidir"]


def cli_euroc_vio(cfg_path, root, u8, truth, tmp):
    """run_euroc --vio on the euroc tree (its IMU csv holds the vio phase's
    euroc_vio+vio stream), held to the VIO step driven directly on the same
    decoded frames and IMU buffers from the same bootstrap."""
    import numpy as np
    import torch
    from rsvio_tpu_torch.cli import run as cli_run
    from rsvio_tpu_torch.cli import run_euroc
    from rsvio_tpu_torch.data import players
    from rsvio_tpu_torch.models import estimator_vio as ev
    from rsvio_tpu_torch.utils import config as config_mod
    from rsvio_tpu_torch.utils import trajectory

    n = len(u8)
    dev = torch.device("cuda")
    traj = os.path.join(tmp, "euroc_vio.txt")
    reset_counts()
    rc = run_euroc.main([cfg_path, root, "--vio", "--trajectory-out", traj,
                         "--eval-ate", "--quiet"])
    c = counts()
    res = run_euroc.main.last_result
    check(rc == 0 and res.n_failed == 0,
          f"cli[euroc --vio]: rc {rc}, failed frames {res.n_failed}")
    check(c == {"klt_bidir": 2 * n, "klt_bidir_rot": 0, "klt_level": 0},
          f"cli[euroc --vio]: launches {c} for {n} frames")
    with open(os.path.join(root, "statistics.txt")) as f:
        m = re.search(r"ate_rmse_m: (\S+)", f.read())
    check(m is not None, "cli[euroc --vio]: no ATE in statistics.txt")

    cfg = config_mod.load_config(cfg_path)
    ecfg, rig = config_mod.make_estimator_config(cfg, kind="vio", device=dev)
    vcfg = cli_run.vio_config(cfg, ecfg)
    samples = players.EurocPlayer(root).load_imu()
    imu = {"ts": np.asarray([s_.timestamp_ns for s_ in samples]),
           "gyro": np.asarray([s_.gyro for s_ in samples], np.float32),
           "accel": np.asarray([s_.accel for s_ in samples], np.float32)}
    state = cli_run.vio_bootstrap(vcfg, imu, torch.float32, dev)
    step = ev.make_vio_estimator_step(vcfg)
    ts = stamps(n)
    poses, step_ms = [], []
    for k, (a, b) in enumerate(u8):
        a, b = (torch.from_numpy(x).to(dev).float() for x in (a, b))
        buf = cli_run._imu_buffer_for_frame(imu, ts[k - 1] if k else None,
                                            ts[k])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, out = step(state, rig, a, b, *buf)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        poses.append(out.T_W_B.double().cpu().numpy())
    t_cli, pos_cli, q_cli = trajectory.load_tum(traj)
    check(len(t_cli) == n, f"cli[euroc --vio]: {len(t_cli)} poses")
    dpos = float(np.abs(pos_cli - np.stack([p[:3, 3] for p in poses])).max())
    drot = float(quat_angle(q_cli, np.stack(
        [trajectory.rot_to_quat_np(p[:3, :3]) for p in poses])).max())
    line = {**ms_stats(res), "direct_blocked_median_ms": statistics.median(
        step_ms), "launches": c, "traj_vs_direct_m": dpos,
        "traj_vs_direct_rad": drot, "ate_m": float(m.group(1)),
        "ate_direct_m": float(trajectory.ate_rmse(
            np.stack([p[:3, 3] for p in poses]), truth)[0]),
        "path_m": float(np.linalg.norm(np.diff(truth, axis=0), axis=1).sum()),
        "vel": state.vel.double().cpu().numpy().tolist()}
    print("cli[euroc --vio]: " + json.dumps(line), flush=True)
    check(dpos <= CLI_TOL and drot <= CLI_TOL,
          f"cli[euroc --vio]: trajectory vs direct step {dpos} m, {drot} rad")
    return c["klt_bidir"]


def cli_layout(name, tex, dev, tmp, medians):
    """run_tum (16-bit PNGs, mav0) or run_4seasons (times.txt, GNSS) on
    frames of that config's rig."""
    from rsvio_tpu_torch.cli import run_4seasons, run_tum
    from rsvio_tpu_torch.data import writers

    n = CLI_FRAMES[name]
    cfg_name = {"tum": "tum_vi.yaml", "4seasons": "4seasons.yaml"}[name]
    cfg_path, override = config_copy(cfg_name, tmp)
    ecfg, _, u8, truth = cli_frames(tex, cfg_path, n, dev)
    root = os.path.join(tmp, name)
    if name == "tum":
        writers.write_euroc(root, u8, stamps(n), depth=16,
                            gt_positions=truth)
        main = run_tum.main
    else:
        writers.write_four_seasons(root, u8, stamps(n), gt_positions=truth)
        main = run_4seasons.main
    reset_counts()
    rc = main([cfg_path, root, "--eval-ate", "--quiet"])
    c = counts()
    res = main.last_result
    line = {**ms_stats(res), "configs_blocked_median_ms": medians.get(
        cfg_name), "launches": c, "image_shape": list(ecfg.image_shape),
        "camera": ecfg.cam_kind_l, "override": override}
    print(f"cli[{name}]: " + json.dumps(line), flush=True)
    check(rc == 0 and res.n_failed == 0 and line["frames"] == n,
          f"cli[{name}]: rc {rc}, {line['frames']} of {n} frames, "
          f"{res.n_failed} failed")
    check(c == {"klt_bidir": 2 * n, "klt_bidir_rot": 0, "klt_level": 0},
          f"cli[{name}]: launches {c} for {n} frames")
    return c["klt_bidir"]


def cli_tartanair(tex, dev, tmp, medians):
    """run_tartanair with config/tartanair.yaml on 640x480 left frames."""
    import numpy as np
    import torch
    from rsvio_tpu_torch.cli import run_tartanair
    from rsvio_tpu_torch.data import bench_scene, writers
    from rsvio_tpu_torch.models import mono_tracker as mt

    m = MONO
    cfg_path = os.path.join(ROOT, "config", "tartanair.yaml")
    cfg, make_pyramid = run_tartanair.tracker_settings(cfg_path)
    check((cfg.klt.levels, cfg.klt.pyramid_ratio, cfg.nms_radius,
           cfg.min_score, cfg.klt.max_iterations, cfg.klt.lm_lambda)
          == (m["levels"], m["ratio"], m["radius"], m["min_score"],
              m["max_iter"], m["lm_lambda"]),
          f"cli[tartanair]: the CLI maps tartanair.yaml to {cfg}")
    imgs = [quantize(bench_scene.render(tex, bench_scene.STEP_M * k,
                                        shape=m["shape"], fx=m["fx"]))
            for k in range(MONO_FRAMES)]
    root = writers.write_tartanair(os.path.join(tmp, "tartanair"), imgs)
    reset_counts()
    rc = run_tartanair.main([root, "--config", cfg_path, "--quiet"])
    c = counts()
    res = run_tartanair.main.last_result
    q = range(MONO_WARMUP, MONO_FRAMES)
    kill = float(np.mean([1.0 - res.tracked[i] / max(res.alive[i - 1], 1)
                          for i in q]))
    # The eager mono step driven directly on the same (lossless) frames:
    # the CLI's step is the compiled one on the card.
    table = mt.init_mono_table(cfg.capacity, device=dev)
    direct, prev = ([], []), None
    for k, u8 in enumerate(imgs):
        pyr = make_pyramid(torch.from_numpy(u8).to(dev).float())
        table, stats = mt.mono_tracker_step(table, pyr if k == 0 else prev,
                                            pyr, cfg, first_frame=k == 0)
        prev = pyr
        direct[0].append(int(stats["tracked"]))
        direct[1].append(int(stats["alive"]))
    line = {**ms_stats(res), "mono_phase_blocked_median_ms": medians.get(
        "mono"), "launches": c, "tracked_mean": float(np.mean(
            [res.tracked[i] for i in q])), "kill_rate": kill,
        "counts_equal_direct": (res.tracked, res.alive) == direct}
    print("cli[tartanair]: " + json.dumps(line), flush=True)
    check(line["counts_equal_direct"],
          "cli[tartanair]: counts differ from the eager step's")
    check(rc == 0 and line["frames"] == MONO_FRAMES,
          f"cli[tartanair]: rc {rc}, {line['frames']} frames")
    check(c == {"klt_bidir": MONO_FRAMES - 1, "klt_bidir_rot": 0,
                "klt_level": 0},
          f"cli[tartanair]: launches {c} for {MONO_FRAMES} frames")
    check(line["tracked_mean"] >= 80.0, "cli[tartanair]: tracked_mean < 80")
    check(kill <= 0.3, f"cli[tartanair]: kill rate {kill} > 0.3")

    # --viewer on the recording stub: the same counts, the debug surface.
    reset_counts()
    rc, frames, calls = viewer_run(run_tartanair.main,
                                   [root, "--config", cfg_path, "--quiet"])
    cv = counts()
    shown = run_tartanair.main.last_result
    check(rc == 0 and (shown.tracked, shown.alive) == (res.tracked,
                                                       res.alive),
          f"cli[tartanair --viewer]: rc {rc}, counts differ from the plain "
          f"run")
    check(cv == c, f"cli[tartanair --viewer]: launches {cv}, want {c}")
    want = (["tartanair/left", "tartanair/left/features", "tartanair/labels"]
            + [f"tartanair/pyramid/level_{i}" for i in range(m["levels"])]
            + ["tartanair/shi_tomasi"])
    check(len(frames) == MONO_FRAMES and all(f == want for f in frames),
          f"cli[tartanair --viewer]: entities {frames[:1]}, want {want}")
    last = {call[1]: call[2] for call in calls if call[0] == "log"}
    lab, pts = last["tartanair/labels"], last["tartanair/left/features"]
    check(np.allclose(lab.args[0], np.asarray(pts.args[0]) + 0.5)
          and last["tartanair/shi_tomasi"].args[0].shape == m["shape"]
          and last["tartanair/pyramid/level_4"].kwargs["draw_order"] == 4.0,
          "cli[tartanair --viewer]: debug surface payloads")
    print("cli[tartanair --viewer]: " + json.dumps({
        "frames": len(frames), "launches": cv,
        "counts_equal_plain": True, "logs_per_frame": len(want),
        "viewer_ms_median": float(np.median(
            shown.frame_processing_times_ms)),
        "plain_ms_median": float(np.median(res.frame_processing_times_ms)),
        "viewer_ms_mean": shown.avg_processing_time_ms,
        "plain_ms_mean": res.avg_processing_time_ms}), flush=True)
    return c["klt_bidir"] + cv["klt_bidir"]


def cli_ab(tex, dev):
    """`--cli-ab`: the euroc CLI run's ms a frame against the direct step,
    in turns in one process (direct, cli, cli on frames decoded before the
    run, then again), on the cli phase's euroc frames without the viewer:
    whether the decode thread or the CLI's loop costs the step anything."""
    import shutil
    import tempfile

    import numpy as np
    from rsvio_tpu_torch.cli import run_euroc
    from rsvio_tpu_torch.data import players, writers

    n = CLI_FRAMES["euroc"]
    cfg_path = os.path.join(ROOT, "config", "euroc_vio.yaml")
    ecfg, rig, u8, truth = cli_frames(tex, cfg_path, n, dev)
    tmp = tempfile.mkdtemp(prefix="rsvio_ab_")
    root = writers.write_euroc(os.path.join(tmp, "euroc"), u8, stamps(n),
                               gt_positions=truth)
    load = players._StereoPlayer.load_frame
    decoded = {}

    def load_decoded(self, i, as_uint8=False):
        f = decoded[i]
        return players.FrameData(f.timestamp_ns, f.left, f.right)

    p = players.EurocPlayer(root)
    for i in range(n):
        decoded[i] = load(p, i, as_uint8=True)
    try:
        for k, kind in enumerate(("direct", "cli", "cli_decoded") * 2):
            if kind == "direct":
                ms, dec = direct_run(ecfg, rig, u8, dev)[4], []
            else:
                if kind == "cli_decoded":
                    players._StereoPlayer.load_frame = load_decoded
                try:
                    check(run_euroc.main([cfg_path, root, "--quiet"]) == 0,
                          "cli-ab: the CLI failed")
                finally:
                    players._StereoPlayer.load_frame = load
                res = run_euroc.main.last_result
                ms, dec = res.frame_processing_times_ms, res.decode_times_ms
            print(f"cli_ab[{k}:{kind}]: " + json.dumps({
                "median_ms": statistics.median(ms),
                "mean_ms": float(np.mean(ms)),
                "decode_ms_per_frame": float(np.mean(dec)) if dec else None,
                "frames": len(ms)}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cli_phase(tex, dev, medians):
    """The dataset command lines (module docstring, phase 11); returns
    their K1 launches."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="rsvio_cli_")
    try:
        total = cli_euroc(tex, dev, tmp)
        for name in ("tum", "4seasons"):
            total += cli_layout(name, tex, dev, tmp, medians)
        total += cli_tartanair(tex, dev, tmp, medians)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


DIST_FRAMES, DIST_WARMUP = 30, 6
DIST_W, DIST_L = 10, (256, 1024)
DIST_VO_TOL, DIST_VIO_TOL = 5e-3, 1e-2   # tests/test_dist_estimator.py:66, :138
DIST_TIMEOUT = 600.0


def dist_solver_cases(mesh, L):
    """name -> (sharded solve, single-device solve, pose of a result, prior
    of a result or None) of the four window solvers on W=10 windows with L
    landmarks: dryrun.window_problem (VO) and dryrun.vio_window_problem."""
    import torch
    from rsvio_tpu_torch.models import ba, vio_ba
    from rsvio_tpu_torch.models.marginalization import empty_prior
    from rsvio_tpu_torch.parallel import dist_ba, dist_vio_ba, dryrun

    dev = mesh.device
    prob = dryrun.window_problem(DIST_W, L, seed=1, device=dev)
    vargs = dryrun.vio_window_problem(DIST_W, L, seed=1, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)

    def p6():
        return empty_prior(DIST_W, 6, device=dev)

    def p15():
        return empty_prior(DIST_W, 15, device=dev)

    return {
        "ba": (lambda cfg=ba.BAConfig(): dist_ba.solve_ba_distributed(
            mesh, *prob, cfg), lambda: ba.solve_ba(*prob),
            lambda r: r.T_W_B, lambda r: None),
        "ba_marg": (lambda: dist_ba.solve_ba_marginalized_distributed(
            mesh, *prob, p6(), yes), lambda: ba.solve_ba_marginalized(
                *prob, p6(), yes), lambda r: r[0].T_W_B, lambda r: r[1]),
        "vio": (lambda cfg=vio_ba.VIOBAConfig():
                dist_vio_ba.solve_vio_ba_distributed(mesh, *vargs, cfg),
                lambda: vio_ba.solve_vio_ba(*vargs),
                lambda r: r.state.T_W_B, lambda r: None),
        "vio_marg": (lambda: dist_vio_ba.solve_vio_ba_marginalized_distributed(
            mesh, *vargs, p15(), yes), lambda: vio_ba.solve_vio_ba_marginalized(
                *vargs, p15(), yes), lambda r: r[0].state.T_W_B,
            lambda r: r[1])}


def dist_solvers(mesh):
    """The four sharded solvers against the single-device ones at each L of
    DIST_L, with the all-reduce calls and bytes of each solve; and the
    calls and bytes of one LM iteration (a 20-iteration solve less a
    10-iteration one, over 10) for ba and vio at each L."""
    import torch
    from rsvio_tpu_torch.models import ba, vio_ba

    out = {}
    for L in DIST_L:
        cases = dist_solver_cases(mesh, L)
        for name, (dist_fn, single_fn, pose, prior) in cases.items():
            c0 = dict(mesh.counts)
            rd = dist_fn()
            torch.cuda.synchronize()
            calls = mesh.counts["all_reduce_calls"] - c0["all_reduce_calls"]
            nbytes = mesh.counts["all_reduce_bytes"] - c0["all_reduce_bytes"]
            rs = single_fn()
            ok = [bool((r if hasattr(r, "success") else r[0]).success)
                  for r in (rd, rs)]
            td, ts = pose(rd), pose(rs)
            excess = float(((td - ts).abs() - (1e-4 + 1e-3 * ts.abs()))
                           .max())
            e = {"success": ok, "max_dT": float((td - ts).abs().max()),
                 "tol_excess": excess, "allreduce_calls": calls,
                 "allreduce_bytes": nbytes}
            if prior(rd) is not None:
                pd, ps = prior(rd), prior(rs)
                scale = max(1.0, float(ps.H.abs().max()))
                e["prior_valid"] = [bool(pd.valid), bool(ps.valid)]
                e["max_dH_rel"] = float((pd.H - ps.H).abs().max()) / scale
            out[f"{name}@{L}"] = e
        for name, cfg10 in (("ba", ba.BAConfig(max_iterations=10)),
                            ("vio", vio_ba.VIOBAConfig(max_iterations=10))):
            c0 = dict(mesh.counts)
            cases[name][0](cfg10)
            calls = mesh.counts["all_reduce_calls"] - c0["all_reduce_calls"]
            nbytes = mesh.counts["all_reduce_bytes"] - c0["all_reduce_bytes"]
            full = out[f"{name}@{L}"]
            full["per_iteration_calls"] = (full["allreduce_calls"] - calls) / 10
            full["per_iteration_bytes"] = (full["allreduce_bytes"] - nbytes) / 10
    return out


def dist_collective_ms(mesh, runs=50):
    """Host ms a call (synchronized after `runs` calls) of the mesh's
    packed all-reduce on a W=10 solve's Schur payload ((W,W,6,6) and
    (W,6) float32), and of one bare torch.distributed.all_reduce of the
    same flat buffer: what a collective of the sharded solve costs."""
    import torch
    import torch.distributed as dist

    dev = mesh.device
    S = torch.zeros((DIST_W, DIST_W, 6, 6), device=dev)
    b = torch.zeros((DIST_W, 6), device=dev)
    flat = torch.zeros(S.numel() + b.numel(), device=dev)

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / runs

    out = {"packed_ms": per_call(lambda: mesh.all_reduce_packed(S, b)),
           "bare_ms": per_call(lambda: dist.all_reduce(flat,
                                                       group=mesh.group))}
    mesh.reset_counts()
    return out


def dist_inputs(dev):
    """name -> (vio?, config, rig, frames, IMU buffers or None, state maker,
    truth) of the dist phase's step runs: the main path's default
    EstimatorConfig on the bench frames with and without marginalization,
    and config/euroc_vio.yaml with --vio and marginalization on the vio
    phase's euroc scene and IMU stream."""
    from rsvio_tpu_torch.cli import run as cli_run
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator as est
    from rsvio_tpu_torch.models import estimator_vio as ev
    from rsvio_tpu_torch.utils import config as config_mod

    tex = bench_scene.make_texture(0).to(dev)
    frames = bench_scene.stereo_frames(tex, DIST_FRAMES)
    rig = bench_scene.make_rig(dev)
    cfg = est.EstimatorConfig()
    runs = {name: (False, c, rig, frames, None,
                   lambda c=c: est.init_state(c, device=dev),
                   lambda k: bench_scene.truth_position(rig, k))
            for name, c in (("vo", cfg), ("vo+marg", cfg._replace(
                use_marginalization=True)))}
    ycfg = config_mod.load_config(os.path.join(ROOT, "config",
                                               "euroc_vio.yaml"))
    ycfg.solver.marginalization = True
    ecfg, vrig = config_mod.make_estimator_config(ycfg, kind="vio",
                                                  device=dev)
    vcfg = cli_run.vio_config(ycfg, ecfg)
    kinds = (ecfg.cam_kind_l, ecfg.cam_kind_r)
    vframes = [bench_scene.render_rig(tex, vrig, kinds, k, ecfg.image_shape)
               for k in range(DIST_FRAMES)]
    traj = bench_trajectory(vrig)
    imu, n_head, _, bufs = vio_imu_inputs(traj, DIST_FRAMES, vcfg.imu_params)
    runs["euroc_vio+vio+marg"] = (
        True, vcfg, vrig, vframes, bufs,
        lambda: ev.initialize_vio_state(vcfg, imu["gyro"][:n_head],
                                        imu["accel"][:n_head], device=dev),
        traj)
    return runs


def dist_drive(step, make_state, rig, frames, bufs, compiled=False):
    """Every frame of a run, synchronized after each: per-frame records
    (T_W_B (16), n_tracked, n_alive, ba_success, pose_ok, is_keyframe),
    the ms of the frames after DIST_WARMUP, and the final state.
    `compiled`: a compiled step, every call after the first under
    torch.cuda.set_sync_debug_mode("error") (GraphWatch); then a fourth
    result: per frame, its variant keys and the device ms of its segment K
    (the keyframe stage) on frames with a window solve, else None (CUDA
    events around the variant's run in place, as graph_split)."""
    import torch

    state = make_state()
    rec, ms, variants, k_ms = [], [], [], []
    watch = GraphWatch(step if compiled else None)
    marks = {}
    if compiled:
        run = step.graphs.run

        def timed_run(key, fn):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            run(key, fn)
            ev[1].record()
            marks[key] = ev
        step.graphs.run = timed_run
    torch.cuda.synchronize()
    try:
        for k, (a, b) in enumerate(frames):
            marks.clear()
            t = time.perf_counter()
            state, out = watch.call(k, step, state, rig, a, b,
                                    *(bufs[k] if bufs else ()))
            torch.cuda.synchronize()
            if k >= DIST_WARMUP:
                ms.append((time.perf_counter() - t) * 1e3)
            rec.append(torch.cat([out.T_W_B.reshape(-1).double(),
                                  torch.stack([
                                      out.n_tracked.double(),
                                      out.n_alive.double(),
                                      out.ba_success.double(),
                                      out.pose_ok.double(),
                                      out.is_keyframe.double()])]))
            if compiled:
                solve = [ev for key, ev in marks.items()
                         if key[0] in ("opt", "kf") and len(key) == 3
                         and key[2]]
                variants.append(repr(step.last_variants))
                k_ms.append(solve[0][0].elapsed_time(solve[0][1])
                            if solve else None)
    finally:
        if compiled:
            del step.graphs.run
    r = torch.stack(rec).cpu().numpy()
    if compiled:
        return r, ms, state, (variants, k_ms)
    return r, ms, state


def dist_step_summary(vio, r, ms, state, truth, window, solves):
    """The floors' numbers (check_floors' keys) of a run, its frames/s and
    blocked median over the frames after the warm-up, and its window
    solves (count, median ms, all-reduce calls and bytes each)."""
    import numpy as np

    n = len(r)
    if vio:
        pos = np.concatenate([r[:, 3:12:4], r[:, 16:]], axis=1)
        s = vio_metrics(pos, truth, state.vel.double().cpu().numpy(), window)
    else:
        q = range(DIST_WARMUP, n)
        t_final = r[-1, 3:12:4]
        t_truth = truth(n - 1).double().cpu().numpy()
        s = {"tracked_mean": float(r[q, 16].mean()),
             "bidir_kill_rate": float(np.mean(
                 [1.0 - r[i, 16] / max(r[i - 1, 17], 1) for i in q])),
             "t_final": t_final.tolist(), "t_truth": t_truth.tolist(),
             "drift_rel": float(np.linalg.norm(t_final - t_truth)
                                / max(np.linalg.norm(t_truth), 1e-9)),
             "ba_fires_in_quality_pass": int(r[q, 18].sum()),
             "pose_ok": bool(r[:, 19].all())}
    kf = r[DIST_WARMUP:, 20] > 0.5
    s.update(frames=n, frames_per_s=len(ms) / (sum(ms) / 1e3),
             blocked_median_ms=statistics.median(ms),
             kf_blocked_median_ms=statistics.median(
                 [m for m, f in zip(ms, kf) if f] or [float("nan")]),
             non_kf_blocked_median_ms=statistics.median(
                 [m for m, f in zip(ms, kf) if not f] or [float("nan")]),
             keyframes=int(r[:, 20].sum()), solves=len(solves["ms"]),
             solves_ok=int(r[:, 18].sum()),
             solve_ms_median=(statistics.median(solves["ms"])
                              if solves["ms"] else None))
    if solves["calls"]:
        s["allreduce_calls_per_solve"] = statistics.median(solves["calls"])
        s["allreduce_bytes_per_solve"] = statistics.median(solves["bytes"])
    return s


def timed_solvers(module, names, mesh=None):
    """Wrap module.<name> for each of `names` so each call is synchronized
    before and after and its ms (and the mesh's all-reduce calls and bytes)
    recorded; returns (the record, a function that restores them)."""
    import torch

    rec = {"ms": [], "calls": [], "bytes": []}
    saved = {n: getattr(module, n) for n in names}

    def wrap(fn):
        def f(*a, **kw):
            torch.cuda.synchronize()
            c0 = dict(mesh.counts) if mesh is not None else None
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t) * 1e3)
            if mesh is not None:
                rec["calls"].append(mesh.counts["all_reduce_calls"]
                                    - c0["all_reduce_calls"])
                rec["bytes"].append(mesh.counts["all_reduce_bytes"]
                                    - c0["all_reduce_bytes"])
            return out
        return f

    for n, fn in saved.items():
        setattr(module, n, wrap(fn))

    def restore():
        for n, fn in saved.items():
            setattr(module, n, fn)
    return rec, restore


def dist_rank(mesh, reuse=None):
    """One rank of the dist phase (run by parallel.dryrun.run_ranks): the
    solvers, then the step runs — rank 0 first drives the single-device
    steps alone (eager, then compiled where the mesh can capture; `reuse`:
    (records, summary) of an earlier run's eager single-device runs on the
    same card, which then stand in for them), then every rank the
    distributed ones (K1 launches counted over the distributed runs only),
    then, where the mesh's collectives can be captured (NCCL), the
    compiled distributed ones on the same frames; elsewhere (gloo on the
    card) the compiled makers must refuse. Returns the summary (JSON), the
    distributed runs' per-frame poses, the compiled runs' variant keys and
    rank 0's single-device records (single.*, single_vel.*)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from rsvio_tpu_torch.models import ba, vio_ba
    from rsvio_tpu_torch.models import estimator as est
    from rsvio_tpu_torch.models import estimator_vio as ev
    from rsvio_tpu_torch.parallel import dist_ba, dist_vio_ba
    from rsvio_tpu_torch.parallel import dist_estimator as de
    from rsvio_tpu_torch.utils.precision import pin_fp32

    pin_fp32()
    dev = mesh.device
    summary = {"rank": mesh.rank, "device": str(dev),
               "collective": dist_collective_ms(mesh),
               "solvers": dist_solvers(mesh)}
    runs = dist_inputs(dev)
    single, out = {}, {}
    if reuse is not None:
        single, summary["single"] = reuse
    elif mesh.rank == 0:
        for name, (vio, cfg, rig, frames, bufs, make_state, truth) in \
                runs.items():
            mod, names = ((vio_ba, ("solve_vio_ba", "solve_vio_ba_marginalized"))
                          if vio else (ba, ("solve_ba",
                                            "solve_ba_marginalized")))
            rec, restore = timed_solvers(mod, names)
            try:
                step = (ev.make_vio_estimator_step(cfg) if vio
                        else est.make_estimator_step(cfg))
                r, ms, state = dist_drive(step, make_state, rig, frames, bufs)
            finally:
                restore()
            window = (cfg.base if vio else cfg).window_size
            summary.setdefault("single", {})[name] = dist_step_summary(
                vio, r, ms, state, truth, window, rec)
            vel = state.vel.double().cpu().numpy() if vio else None
            single[name] = (r, vel)
            out[f"single.{name}"] = r
            if vio:
                out[f"single_vel.{name}"] = vel
            if mesh.capturable:
                step = (ev.make_compiled_vio_estimator_step(cfg, device=dev)
                        if vio else est.make_compiled_estimator_step(
                            cfg, device=dev))
                r, ms, state, (_, k_ms) = dist_drive(
                    step, make_state, rig, frames, bufs, compiled=True)
                g = {k: v for k, v in dist_step_summary(
                    vio, r, ms, state, truth, window,
                    {"ms": [], "calls": [], "bytes": []}).items()
                    if k in ("frames_per_s", "blocked_median_ms",
                             "kf_blocked_median_ms",
                             "non_kf_blocked_median_ms")}
                g["k_solve_device_ms_median"] = k_solve_median(k_ms)
                summary.setdefault("single_graph", {})[name] = g
    dist.barrier()
    reset_counts()
    n_frames = 0
    eager = {}
    for name, (vio, cfg, rig, frames, bufs, make_state, truth) in \
            runs.items():
        mod, names = ((dist_vio_ba, ("solve_vio_ba_distributed",
                                     "solve_vio_ba_marginalized_distributed"))
                      if vio else (dist_ba, (
                          "solve_ba_distributed",
                          "solve_ba_marginalized_distributed")))
        rec, restore = timed_solvers(mod, names, mesh)
        c0 = dict(mesh.counts)
        try:
            step = (de.make_distributed_vio_estimator_step(cfg, mesh) if vio
                    else de.make_distributed_estimator_step(cfg, mesh))
            r, ms, state = dist_drive(step, make_state, rig, frames, bufs)
        finally:
            restore()
        n_frames += len(frames)
        window = (cfg.base if vio else cfg).window_size
        s = dist_step_summary(vio, r, ms, state, truth, window, rec)
        s["run_counts"] = {k: mesh.counts[k] - c0[k] for k in c0}
        eager[name] = (r, state, s)
        if name in single:
            rs, vel_s = single[name]
            s["max_dT_vs_single"] = float(np.abs(r[:, :16] - rs[:, :16])
                                          .max())
            s["keyframes_equal"] = bool((r[:, 20] == rs[:, 20]).all())
            if vio:
                s["max_dvel_vs_single"] = float(np.abs(
                    state.vel.double().cpu().numpy() - vel_s).max())
        summary.setdefault("dist", {})[name] = s
        out[f"poses.{name}"] = r[:, :16]
    summary["launches"] = counts()
    summary["frames"] = n_frames
    summary["mesh_counts"] = dict(mesh.counts)
    if mesh.capturable:
        reset_counts()
        for name, (vio, cfg, rig, frames, bufs, make_state, truth) in \
                runs.items():
            summary.setdefault("graph", {})[name], out[
                f"poses.graph.{name}"], out[f"variants.{name}"] = \
                dist_graph_run(mesh, name, runs[name], eager[name])
        summary["graph_launches"] = counts()
    else:
        # The compiled makers refuse a mesh whose collectives a CUDA graph
        # cannot hold (gloo), before touching CUDA.
        refused = {}
        for vio, make in ((False, de.make_compiled_distributed_estimator_step),
                          (True,
                           de.make_compiled_distributed_vio_estimator_step)):
            cfg = next(c for v, c, *_ in runs.values() if v == vio)
            try:
                make(cfg, mesh)
                refused[make.__name__] = None
            except ValueError as e:
                refused[make.__name__] = str(e)
        summary["graph_refused"] = refused
    out["summary"] = np.array(json.dumps(summary))
    return out


def k_solve_median(k_ms):
    """The median device ms of segment K on the solve frames after the
    warm-up (dist_drive's fourth result), None without one."""
    v = [x for x in k_ms[DIST_WARMUP:] if x is not None]
    return statistics.median(v) if v else None


def dist_graph_run(mesh, name, run, eager):
    """The compiled distributed step of dist run `name` on its frames
    (every call after the first under the sync debug mode's "error"),
    beside the eager distributed run `eager` ((records, final state,
    summary)): its summary (frames/s, blocked medians, K's device ms on
    solve frames, the gaps to the eager run, the run's collective counts,
    reads a frame, each variant's ms of first run and capture, the memory
    its graphs and buffers hold), its per-frame poses and variant keys."""
    import numpy as np
    import torch
    from rsvio_tpu_torch.parallel import dist_estimator as de

    vio, cfg, rig, frames, bufs, make_state, truth = run
    r_e, st_e, s_e = eager
    pool0 = pool_bytes()
    c0 = dict(mesh.counts)
    t0 = time.perf_counter()
    step = (de.make_compiled_distributed_vio_estimator_step(cfg, mesh) if vio
            else de.make_compiled_distributed_estimator_step(cfg, mesh))
    r, ms, state, (variants, k_ms) = dist_drive(step, make_state, rig, frames,
                                                bufs, compiled=True)
    window = (cfg.base if vio else cfg).window_size
    s = dist_step_summary(vio, r, ms, state, truth, window,
                          {"ms": [], "calls": [], "bytes": []})
    g = {k: s[k] for k in ("frames_per_s", "blocked_median_ms",
                           "kf_blocked_median_ms", "non_kf_blocked_median_ms",
                           "tracked_mean", "drift_rel", "keyframes",
                           "solves_ok")}
    g.update(
        eager_frames_per_s=s_e["frames_per_s"],
        eager_blocked_median_ms=s_e["blocked_median_ms"],
        eager_kf_blocked_median_ms=s_e["kf_blocked_median_ms"],
        eager_solve_ms_median=s_e["solve_ms_median"],
        speedup_fps=s["frames_per_s"] / s_e["frames_per_s"],
        k_solve_device_ms_median=k_solve_median(k_ms),
        k_solve_frames=sum(v is not None for v in k_ms[DIST_WARMUP:]),
        max_pos_gap_m=float(np.abs(r[:, 3:12:4] - r_e[:, 3:12:4]).max()),
        keyframes_equal=bool((r[:, 20] == r_e[:, 20]).all()),
        run_counts={k: mesh.counts[k] - c0[k] for k in c0},
        host_reads_per_frame=step.host_reads / len(frames),
        capture_ms={variant_name(k): v
                    for k, v in step.graphs.capture_ms.items()},
        graphs=len(step.graphs.graphs), replays=step.graphs.replays,
        pool_bytes=pool_bytes() - pool0, seconds=time.perf_counter() - t0)
    if vio:
        g["max_dvel_vs_eager"] = float((state.vel - st_e.vel).abs().max())
        g["vel_err"] = s["vel_err"]
    return g, r[:, :16], np.array(variants)


def dist_phase():
    """The distributed layer (module docstring, phase 12): the NCCL run at
    one rank per card and the gloo run at 2 ranks on card 0, the latter
    held to the former's single-device runs (the same frames on the same
    card). Returns the K1 launches of both runs' eager distributed steps
    and of the NCCL run's compiled ones, all ranks."""
    import torch

    total = graph_total = 0
    reuse = None
    for backend, n in (("nccl", torch.cuda.device_count()), ("gloo", 2)):
        launches, graph_launches, reuse = dist_run(backend, n, reuse)
        total += launches
        graph_total += graph_launches
    return total, graph_total


def dist_run(backend, n, reuse=None):
    """One run of the dist phase: `n` ranks over `backend` on the card(s),
    checked and printed. Returns the K1 launches of its eager distributed
    steps and of its compiled ones (all ranks) and the single-device
    records (`reuse` when given, else rank 0's) for a later run's
    `reuse`."""
    import numpy as np
    from rsvio_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    res = dryrun.run_ranks(dist_rank, n, reuse, backend=backend,
                           devices="cuda", timeout=DIST_TIMEOUT)
    total = graph_total = 0
    sums = [json.loads(str(r["summary"])) for r in res]
    tag = f"dist[{backend} x{n}]"
    s0 = sums[0]
    for name, e in s0["solvers"].items():
        check(all(e["success"]), f"{tag}: solver {name} failed {e}")
        check(e["tol_excess"] <= 0.0,
              f"{tag}: solver {name} poses beyond 1e-3 rel + 1e-4 abs "
              f"of the single-device solve: {e}")
        if "max_dH_rel" in e:
            check(all(e["prior_valid"]) and e["max_dH_rel"] <= 5e-3,
                  f"{tag}: solver {name} prior: {e}")
    for name in ("ba", "vio"):
        per = [s0["solvers"][f"{name}@{L}"] for L in DIST_L]
        check(len({(p["per_iteration_calls"], p["per_iteration_bytes"])
                   for p in per}) == 1,
              f"{tag}: {name} all-reduce per iteration differs with L: "
              f"{per}")
    for name, s in s0["dist"].items():
        vio = "vio" in name
        tol = DIST_VIO_TOL if vio else DIST_VO_TOL
        check_floors(f"{tag}[{name}]", s)
        if vio:
            check(s["vel_err"] <= VIO_VEL_TOL,
                  f"{tag}[{name}]: velocity error {s['vel_err']}")
        check(s["max_dT_vs_single"] <= tol and s["keyframes_equal"],
              f"{tag}[{name}]: {s['max_dT_vs_single']} from the "
              f"single-device step (tol {tol}), keyframes equal "
              f"{s['keyframes_equal']}")
        if vio:
            check(s["max_dvel_vs_single"] <= tol,
                  f"{tag}[{name}]: velocity {s['max_dvel_vs_single']} "
                  f"from the single-device step")
        check(s["solves_ok"] >= 1, f"{tag}[{name}]: no sharded solve")
    for r in res[1:]:
        for k, v in res[0].items():
            if k.startswith(("poses.", "variants.")):
                check(np.array_equal(r[k], v),
                      f"{tag}: {k} differs between ranks")
    for s in sums:
        check(s["launches"] == {"klt_bidir": 2 * s["frames"],
                                "klt_bidir_rot": 0, "klt_level": 0},
              f"{tag}: rank {s['rank']} launches {s['launches']} for "
              f"{s['frames']} frames")
        total += s["launches"]["klt_bidir"]
    line = {
        "ranks": n, "seconds": time.perf_counter() - t0,
        "collective": [s["collective"] for s in sums],
        "solvers": s0["solvers"], "single": s0["single"],
        "dist": {f"rank{s['rank']}": s["dist"] for s in sums},
        "launches": [s["launches"] for s in sums],
        "mesh_counts": [s["mesh_counts"] for s in sums]}
    if backend == "nccl":
        graph_total += dist_graph_checks(tag, sums)
        line.update(single_graph=s0["single_graph"],
                    graph={f"rank{s['rank']}": s["graph"] for s in sums},
                    graph_launches=[s["graph_launches"] for s in sums])
    else:
        for s in sums:
            check(all(s["graph_refused"].values()),
                  f"{tag}: a compiled maker did not refuse gloo: "
                  f"{s['graph_refused']}")
        line["graph_refused"] = s0["graph_refused"]
    print(f"{tag}: " + json.dumps(line), flush=True)
    reuse = reuse or ({name: (res[0][f"single.{name}"],
                              res[0].get(f"single_vel.{name}"))
                       for name in s0["single"]}, s0["single"])
    return total, graph_total, reuse


def dist_graph_checks(tag, sums):
    """The compiled distributed runs' checks (module docstring, phase 12);
    returns their K1 launches, all ranks."""
    total = 0
    for s in sums:
        for name, g in s["graph"].items():
            t = f"{tag}[graph {name}] rank {s['rank']}"
            e = s["dist"][name]
            check(g["max_pos_gap_m"] <= GRAPH_POSE_TOL
                  and g["keyframes_equal"],
                  f"{t}: positions {g['max_pos_gap_m']} m from the eager "
                  f"distributed step's, keyframes equal "
                  f"{g['keyframes_equal']}")
            if "max_dvel_vs_eager" in g:
                check(g["max_dvel_vs_eager"] <= GRAPH_POSE_TOL,
                      f"{t}: velocity {g['max_dvel_vs_eager']} from eager")
            check(g["run_counts"] == e["run_counts"],
                  f"{t}: mesh counts {g['run_counts']}, eager "
                  f"{e['run_counts']}")
            check(g["host_reads_per_frame"] == 1.0,
                  f"{t}: {g['host_reads_per_frame']} blocking reads a frame")
            check(g["solves_ok"] >= 1, f"{t}: no sharded solve")
        frames = s["frames"]
        check(s["graph_launches"] == {"klt_bidir": 2 * frames,
                                      "klt_bidir_rot": 0, "klt_level": 0},
              f"{tag}: rank {s['rank']} compiled launches "
              f"{s['graph_launches']} for {frames} frames")
        total += s["graph_launches"]["klt_bidir"]
    return total


EVAL_FRAMES = 80       # tools/accuracy_matrix runs 160: cut for the time
EVAL_FPS = 20.0
EVAL_SEED = 7          # the matrix's --seed (per-scene rng: + crc32(scene))
EVAL_RUNS = (("depth_6dof", "vo_fifo"), ("occlusion_6dof", "vo_adapt"),
             ("occlusion_6dof", "vio_adapt"))
# The JAX package's occlusion_6dof x vio_adapt over the matrix's 160 frames,
# re-run at the shipped bias stiffness (VERDICT.md:144-146): another length,
# printed beside the port's row, not a bound.
EVAL_JAX_VIO_ADAPT = "0.1548 m ATE / 3.35 % drift (JAX, 160 frames)"


def eval_sequence(name, dev):
    """(scene, sequence, bootstrap gyro, accel) of a matrix scene at the
    matrix's full-width geometry, EVAL_FRAMES frames with its IMU noise
    and biases from its per-scene rng."""
    from rsvio_tpu_torch.data import synthetic
    from rsvio_tpu_torch.tools import accuracy_matrix as am
    from rsvio_tpu_torch.utils import evaluation

    H, W = am.geometry(752)[:2]
    scene_fn, traj_fn = synthetic.MATRIX_SCENES[name]
    scene, traj = scene_fn(H=H, W=W, device=dev), traj_fn()
    rng = am.scene_rng(EVAL_SEED, name)
    kw = am.imu_kwargs(rng)
    seq = synthetic.generate_sequence(scene, traj, EVAL_FRAMES, fps=EVAL_FPS,
                                      imu_rate=200.0, imu_kwargs=kw)
    gyro, accel = evaluation.static_init_imu(
        traj, rng=rng, gyro_bias=kw["gyro_bias"], accel_bias=kw["accel_bias"],
        gyro_noise=kw["gyro_noise"], accel_noise=kw["accel_noise"])
    return scene, seq, gyro, accel


def eval_phase(dev):
    """The evaluation harness on the card (module docstring, phase 13):
    utils.evaluation.run_synthetic_sequence on the accuracy matrix's
    scenes and profiles at full width, each run eager (with the probe)
    and compiled (without). Returns the K1 launches of the eager runs and
    of the compiled ones."""
    import numpy as np
    import torch
    from rsvio_tpu_torch.tools import accuracy_matrix as am
    from rsvio_tpu_torch.utils import evaluation

    _, _, levels, cell, margin = am.geometry(752)
    profiles = dict(am.CONFIGS)
    scenes = {}
    total = graph_total = 0
    for scene_name, cname in EVAL_RUNS:
        if scene_name not in scenes:
            t0 = time.perf_counter()
            scenes[scene_name] = eval_sequence(scene_name, dev)
            torch.cuda.synchronize()
            print(f"eval: {scene_name} rendered, {EVAL_FRAMES} frames in "
                  f"{time.perf_counter() - t0:.2f}s", flush=True)
        scene, seq, gyro, accel = scenes[scene_name]
        ckw = profiles[cname]
        vio = ckw["use_vio"]
        tag = f"eval[{scene_name} x {cname}]"
        probe = {}
        t0 = time.perf_counter()
        kw = dict(capacity=256, window=10, levels=levels, cell_size=cell,
                  detect_margin=margin, init_gyro=gyro if vio else None,
                  init_accel=accel if vio else None, device=dev, **ckw)
        reset_counts()
        res = evaluation.run_synthetic_sequence(seq, scene, probe=probe,
                                                **kw)
        c = counts()
        # The same frames through the compiled harness (no probe).
        t1 = time.perf_counter()
        reset_counts()
        res_g = evaluation.run_synthetic_sequence(seq, scene, **kw)
        cg = counts()
        check(cg == {"klt_bidir": 2 * EVAL_FRAMES, "klt_bidir_rot": 0,
                     "klt_level": 0},
              f"{tag}: compiled launches {cg} for {EVAL_FRAMES} frames")
        gap = float(np.abs(res_g.positions - res.positions).max())
        check(gap <= GRAPH_POSE_TOL,
              f"{tag}: the compiled harness's positions {gap} m from the "
              f"eager harness's")
        graph = {"fps": res_g.fps, "max_pos_gap_m": gap,
                 "ate_rmse_m": res_g.ate_rmse, "drift_pct": res_g.drift_pct,
                 "launches": cg, "seconds": time.perf_counter() - t1}
        st = res.stats
        n = EVAL_FRAMES
        check(c == {"klt_bidir": 2 * n, "klt_bidir_rot": 0, "klt_level": 0},
              f"{tag}: launches {c} for {n} frames")
        check(bool(np.isfinite(res.positions).all()),
              f"{tag}: a non-finite pose")
        # Frames where the gate ran, found a consensus and rejected tracks.
        inl = st["n_ransac_inliers"]
        cut = (inl > 0) & (inl < st["n_pnp_candidates"])
        rec = {"frames": n, "seconds": time.perf_counter() - t0,
               "graph": graph,
               "ate_rmse_m": res.ate_rmse, "drift_pct": res.drift_pct,
               "fps": res.fps, "tracked_mean": res.n_tracked_mean,
               "ba_success_rate": res.ba_success_rate, "skip": res.skip,
               "keyframes": int(st["is_keyframe"].sum()),
               "pnp_ok_share": float(st["pnp_success"].mean()),
               "health_min": float(st["health"].min()),
               "n_dyn_killed": int(st["n_dyn_killed"].sum()),
               "probe": {k: int(v) for k, v in probe.items()},
               "launches": c}
        if ckw.get("ransac"):
            rec.update(gate_cut_frames=int(cut.sum()),
                       gate_cut_share=float(cut.mean()))
        if cname == "vo_fifo":
            check(res.n_tracked_mean >= 80 and res.ba_success_rate == 1.0
                  and res.drift_pct <= 2.0,
                  f"{tag}: floors (tracked_mean >= 80, ba_success_rate 1, "
                  f"drift <= 2 %): {rec}")
        if cname == "vo_adapt":
            check(cut.any(), f"{tag}: the RANSAC gate cut no track: {rec}")
            check(rec["health_min"] < 1.0,
                  f"{tag}: health never dropped below 1: {rec}")
        if cname == "vio_adapt":
            check(rec["n_dyn_killed"] > 0
                  or rec["probe"].get("flow_tracked", 0) > 0,
                  f"{tag}: the scene-flow gate tracked and killed "
                  f"nothing: {rec}")
            rec["jax_full_run"] = EVAL_JAX_VIO_ADAPT
        total += c["klt_bidir"]
        graph_total += cg["klt_bidir"]
        print(f"{tag}: " + json.dumps(rec), flush=True)
    return total, graph_total


def dist_profile(dev, runs=5):
    """One NCCL rank made in this process: the W=10, L=256 window's
    sharded BA (dist_ba) and single-device BA in turns (single, dist,
    dist, single), each `runs` solves synchronized at the end for the wall
    ms a solve; then torch.profiler over `runs` solves of each, printing
    the host ops by self CPU time and the device time in all. Prints no
    result line."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from rsvio_tpu_torch.models import ba
    from rsvio_tpu_torch.parallel import dist_ba, dryrun
    from rsvio_tpu_torch.parallel import mesh as mesh_mod

    m = mesh_mod.make_mesh(backend="nccl")
    try:
        prob = dryrun.window_problem(DIST_W, DIST_L[0], seed=1, device=dev)
        solves = {"single": lambda: ba.solve_ba(*prob),
                  "dist": lambda: dist_ba.solve_ba_distributed(m, *prob)}

        def wall_ms(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3 / runs

        for fn in solves.values():
            fn()
        turns = {name: [] for name in solves}
        for name in ("single", "dist", "dist", "single"):
            turns[name].append(wall_ms(solves[name]))
        print("dist_profile: wall ms a solve " + json.dumps(turns),
              flush=True)
        for name, fn in solves.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
            ka = prof.key_averages()
            device_us = sum(e.self_device_time_total for e in ka)
            cpu_us = sum(e.self_cpu_time_total for e in ka)
            print(f"dist_profile[{name}]: {runs} solves, self CPU "
                  f"{cpu_us / 1e3:.1f} ms, device {device_us / 1e3:.1f} ms",
                  flush=True)
            print(ka.table(sort_by="self_cpu_time_total", row_limit=25),
                  flush=True)
    finally:
        dist.destroy_process_group()


TOOLS_CALLS = 5          # bench_solvers' -n (the tool's default is 20)
GPU_TESTS = ("test_compiled_dist_step_on_cuda_matches_eager",
             "test_compiled_function_on_cuda_matches_eager",
             "test_eval_harness_compiled_on_cuda_matches_eager")
GPU_TESTS_CASES = 7      # their parametrized cases
GPU_TESTS_TIMEOUT = 300.0


def tools_phase():
    """tools.bench_solvers and tools.profile_components (module docstring,
    phase 15): each once compiled, the tools' default, and once with
    --eager, in this call. Returns the K1 launches of the compiled
    run."""
    from rsvio_tpu_torch.tools import bench_solvers, profile_components

    out, launches = {}, 0
    for kind, extra in (("graph", []), ("eager", ["--eager"])):
        reset_counts()
        solvers = bench_solvers.main(["-n", str(TOOLS_CALLS)] + extra)
        comp = profile_components.main(extra)
        c = counts()
        check(comp["klt_bidir_20_launches"] == 1
              and comp["klt_bidir_8_launches"] == 1
              and c == {"klt_bidir": 14, "klt_bidir_rot": 0, "klt_level": 0},
              f"tools[{kind}]: K1 launches {c}, a call {comp}")
        out[kind] = {"solvers_ms": solvers, "components_ms": comp,
                     "launches": c}
        if kind == "graph":
            launches = c["klt_bidir"]
    out["eager_over_graph"] = {
        k: out["eager"][part][k] / out["graph"][part][k]
        for part in ("solvers_ms", "components_ms")
        for k in out["graph"][part] if not k.endswith("_launches")}
    print("tools: " + json.dumps(out), flush=True)
    return launches


def gpu_tests_phase():
    """The gpu tests of the compiled distributed steps, the compiled
    function and the compiled harness (module docstring, phase 16), in a
    pytest process of their own."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-o",
           "addopts=-q", "-p", "no:cacheprovider",
           os.path.join("tests", "test_torch_gpu.py"), "-k",
           " or ".join(GPU_TESTS)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=GPU_TESTS_TIMEOUT)
    lines = r.stdout.strip().splitlines()
    print("gpu_tests: " + json.dumps({
        "rc": r.returncode, "summary": lines[-1] if lines else "",
        "seconds": time.perf_counter() - t0}), flush=True)
    check(r.returncode == 0 and lines
          and re.search(rf"\b{GPU_TESTS_CASES} passed\b", lines[-1])
          and "skipped" not in lines[-1],
          "gpu_tests: " + "\n".join(lines[-30:]) + r.stderr[-2000:])


def kernel_entry(name, launches, rows, extra=None):
    r0 = rows[0]
    e = {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches,
         "max_abs_err": max(r["err"] for r in rows), "ms": r0["ms"],
         "plain_ms": r0["plain_ms"], "bound_ms": r0["bound_ms"],
         "bound_by": r0["bound_by"], "library_ms": None,
         "device_ms": r0["device_ms"], "max_chain": r0["max_chain"],
         "ns_per_link": r0["ns_per_link"]}
    e.update(extra or {})
    return e


def ba_entry(bres, launches, graph_launches):
    """K3's entry in the kernels line: the gated float32 row's numbers, the
    ungated row's beside them, its launches on the main path (eager, gate
    off: 21 a solve) and inside the graph phase's compiled steps."""
    r0, r1 = bres["ba_assemble_gate_float32"], bres["ba_assemble_float32"]
    return {"name": "ba_assemble", "route": "cuda", "source": BA_SOURCE,
            "replaces": None, "launches": launches,
            "launches_graph": graph_launches,
            "max_rel_err": max(r["err"] for r in bres.values()),
            "ms": r0["ms"], "plain_ms": r0["plain_ms"],
            "bound_ms": r0["bound_ms"], "bound_by": r0["bound_by"],
            "library_ms": None, "device_ms": r0["device_ms"],
            **{f"{k}_nogate": r1[k] for k in ("ms", "device_ms", "plain_ms",
                                              "bound_ms")}}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.ops.cuda import ba_kernel as bk
    from rsvio_tpu_torch.ops.cuda import klt_kernel as kk
    from rsvio_tpu_torch.utils.precision import pin_fp32

    print(f"gpu: {gpu_name_and_power()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    pin_fp32()
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    built = kk.load_library()
    print(f"build: {time.perf_counter() - t0:.2f}s (nvcc {built.seconds:.2f}s)"
          f" {os.path.relpath(built.path)}", flush=True)
    kernel = "?"
    for line in built.log.splitlines():
        m = re.search(r"(klt_(?:bidir|level)_kernel)ILb([01])E", line)
        m3 = re.search(r"(ba_(?:assemble|reduce)_kernel)I([fd])E", line)
        if "Compiling entry" in line and m:
            kernel = f"{m.group(1)}<rot={m.group(2)}>"
        elif "Compiling entry" in line and m3:
            kernel = (f"{m3.group(1)}<"
                      f"{'float' if m3.group(2) == 'f' else 'double'}>")
        elif "registers" in line or "spill" in line:
            print(f"ptxas: {kernel}: {line.split(':')[-1].strip()}",
                  flush=True)

    t0 = time.perf_counter()
    tex = bench_scene.make_texture(0).to(dev)
    n = WARMUP + TIMED + QUAL + SPLIT
    frames = bench_scene.stereo_frames(tex, n)
    x11 = bench_scene.STEP_M * 11
    rolled = (bench_scene.render(tex, x11, roll=ROLL),
              bench_scene.render(tex, x11 + bench_scene.BASELINE_M,
                                 roll=ROLL))
    torch.cuda.synchronize()
    print(f"render: {n} stereo frames in {time.perf_counter() - t0:.2f}s",
          flush=True)

    if "--cli-ab" in sys.argv[1:]:
        cli_ab(tex, dev)
        return 0
    if "--dist-profile" in sys.argv[1:]:
        dist_profile(dev)
        return 0
    if "--dist-nccl" in sys.argv[1:]:
        # One rank per card on every card of the machine (on four cards:
        # the compiled distributed steps across real NCCL ranks).
        from rsvio_tpu_torch.parallel import dryrun
        n = torch.cuda.device_count()
        dryrun.dryrun_multichip(n, backend="nccl")
        dist_run("nccl", n)
        return 0

    seconds = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    kres = phase("kernel", kernel_phase, frames, rolled, dev)
    bres = phase("ba_kernel", ba_kernel_phase, dev)
    phase("agree", agree_phase, dev)
    level_launches, (fusion, fusion_launches) = phase(
        "track_points", track_points_phase, frames, rolled, dev)
    ba0 = bk.ba_assemble.launches
    launches = phase("main", main_phase, frames, dev)
    ba_launches = bk.ba_assemble.launches - ba0
    rot_launches = phase("rotation", rotation_phase, frames, dev)
    medians = {}
    mono_launches = phase("mono", mono_phase, tex, dev, medians)
    config_launches = phase("configs", configs_phase, tex, dev, medians)
    option_launches = phase("options", options_phase, tex, frames, dev)
    vio_launches = phase("vio", vio_phase, tex, dev)
    ba0 = bk.ba_assemble.launches
    graph_launches = phase("graph", graph_phase, dev)
    ba_graph_launches = bk.ba_assemble.launches - ba0
    cli_launches = phase("cli", cli_phase, tex, dev, medians)
    dist_launches, dist_graph_launches = phase("dist", dist_phase)
    eval_launches, eval_graph_launches = phase("eval", eval_phase, dev)
    tools_launches = phase("tools", tools_phase)
    phase("gpu_tests", gpu_tests_phase)
    print("phase_seconds: " + json.dumps(seconds), flush=True)

    print(json.dumps({"kernels": [
        kernel_entry("klt_bidir", launches,
                     [kres["temporal"], kres["stereo"], kres["temporal2048"]],
                     {**{f"{k}_{shape}": kres[shape][k]
                         for shape in ("stereo", "temporal2048")
                         for k in ("ms", "device_ms", "plain_ms",
                                   "bound_ms", "max_chain", "ns_per_link")},
                      "launches_mono": mono_launches,
                      "launches_configs": config_launches,
                      "launches_options": option_launches,
                      "launches_vio": vio_launches,
                      "launches_cli": cli_launches,
                      "launches_dist": dist_launches,
                      "launches_dist_graph": dist_graph_launches,
                      "launches_eval": eval_launches,
                      "launches_eval_graph": eval_graph_launches,
                      "launches_tools": tools_launches,
                      "launches_graph": graph_launches["klt_bidir"],
                      **fusion}),
        kernel_entry("klt_bidir_rot", rot_launches, [kres["temporal_rot"]],
                     {"launches_graph": graph_launches["klt_bidir_rot"]}),
        kernel_entry("klt_level", level_launches,
                     [kres["level0"], kres["level3"], kres["level0_rot"],
                      kres["level3_rot"]],
                     {"dead_ms": kres["level0"]["dead_ms"],
                      "launches_fusion": fusion_launches["klt_level"],
                      **{f"{k}_{lvl}": kres[lvl][k]
                         for lvl in ("level3", "level0_rot", "level3_rot")
                         for k in ("ms", "device_ms", "dead_ms", "plain_ms",
                                   "bound_ms", "max_chain", "ns_per_link")}}),
        ba_entry(bres, ba_launches, ba_graph_launches),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
