"""The port's command lines against the JAX package's, on the CPU.

A mini EuRoC tree (8 stereo frames, 120x160, written with ``write_png``,
rows cycling through all five PNG filters; the config of
tests/test_players_cli.py with ``tracker: backend: pallas``, so the JAX step
runs its KLT kernel in interpret mode as tests/test_torch_estimator.py
does) goes through ``rsvio_tpu.cli.run_euroc.main`` once (module fixture)
and through the port's ``run_euroc.main([..., "--device", "cpu"])``.

Tolerances:
  * JAX vs port: positions and rotations within POSE_TOL = 1e-3 m / rad
    (the step tolerance of tests/test_torch_estimator.py); the per-frame
    kf / pnp / ba / tracked / lm fields of the ``[Timing]`` lines equal;
    the keyframe files' timestamps equal, their poses within POSE_TOL.
  * The port's CLI vs the port's step driven directly over the same frames
    (or its checkpoint, resume, layout or option variant): equal to the
    trajectory file's 6 decimals (FILE_TOL), since both run the same code
    on the same inputs.
  * TartanAir: the port's logged tracked / alive equal the port's
    ``mono_tracker_step`` driven directly. Against the JAX CLI they are held
    to TRACK_COUNT_TOL: JAX's CPU ``auto`` route is its gather route, which
    differs from the kernel route the port runs by up to 0.0172 px
    (BENCH_r05.json), enough to flip a track at the bidirectional gate or a
    corner at the detection threshold.
"""

import json
import logging
import os
import re
import shutil

import numpy as np
import pytest
import torch

from rsvio_tpu.cli import run_euroc as jrun_euroc
from rsvio_tpu.cli import run_tartanair as jrun_tartanair
from rsvio_tpu_torch.cli import run_4seasons as trun_4seasons
from rsvio_tpu_torch.cli import run_euroc as trun_euroc
from rsvio_tpu_torch.cli import run_tartanair as trun_tartanair
from rsvio_tpu_torch.cli import run_tum as trun_tum
from rsvio_tpu_torch.data import writers
from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.models import mono_tracker as tmono
from rsvio_tpu_torch.ops.cuda.build import KernelError
from rsvio_tpu_torch.utils import checkpoint as tckpt
from rsvio_tpu_torch.utils import config as tconfig
from rsvio_tpu_torch.utils import trajectory as ttraj

torch.set_num_threads(2)

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config")
H, W, N = 120, 160, 8
T0 = 1_403_636_579_763_555_584   # EuRoC-like epoch stamps (ns)
STAMPS = [T0 + 50_000_000 * k for k in range(N)]
POSE_TOL = 1e-3
FILE_TOL = 2e-6
TRACK_COUNT_TOL = 3
TIMING = re.compile(r"\[Timing\] frame (\d+): .*kf=(\d) pnp=(\d) "
                    r"ba=(\d)\(it=\d+\) tracked=(\d+) lm=(\d+)")
MONO = re.compile(r"\[Timing\] frame (\d+): .*tracked=(\d+) alive=(\d+)")

CONFIG = f"""%YAML:1.0
---
camera:
  image_width: {W}
  image_height: {H}
  left_intrinsics: [100.0, 100.0, {W / 2}, {H / 2}]
  left_distortion: [0.0, 0.0, 0.0, 0.0]
  right_intrinsics: [100.0, 100.0, {W / 2}, {H / 2}]
  right_distortion: [0.0, 0.0, 0.0, 0.0]
  T_B_Cl: [1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1]
  T_B_Cr: [1,0,0,0.11, 0,1,0,0, 0,0,1,0, 0,0,0,1]
keyframe_management:
  keyframe_window_size: 4
  translation_threshold: 0.01
  rotation_threshold: 0.05
feature_detection:
  grid_size: 24
  max_features_per_grid: 1
  optical_flow_max_iterations: 10
  optical_flow_convergence_threshold: 0.01
optimization:
  pnp_max_iterations: 5
  bundle_adjustment_max_iterations: 8
tracker:
  pyramid_levels: 3
  feature_capacity: 64
  detect_margin: 10
  min_corner_score: 5.0
  backend: pallas
"""


def texture(h, w, seed=0):
    """Bicubic upscale of (h/6, w/6) uniform noise, uint8 (numpy seeds)."""
    rng = np.random.default_rng(seed)
    small = torch.from_numpy(
        rng.uniform(0, 255, (h // 6, w // 6)).astype(np.float32))
    up = torch.nn.functional.interpolate(small[None, None], size=(h, w),
                                         mode="bicubic", align_corners=False)
    return up[0, 0].round().clamp(0, 255).to(torch.uint8).numpy()


def stereo_frames(n=N, h=H, w=W):
    """The mini sequence of make_mini_euroc: a texture shifting (k, 2k) px
    a frame, the right view 6 px further."""
    base = texture(2 * h, 2 * w)
    return [(np.ascontiguousarray(base[k:k + h, 2 * k:2 * k + w]),
             np.ascontiguousarray(base[k:k + h, 2 * k + 6:2 * k + 6 + w]))
            for k in range(n)]


def gt_positions(n=N):
    return np.stack([0.02 * np.arange(n), np.zeros(n), np.zeros(n)], axis=1)


def make_tree(root, frames=None, stamps=None, extra_cfg="", depth=8,
              layout="euroc"):
    frames = stereo_frames() if frames is None else frames
    stamps = STAMPS[:len(frames)] if stamps is None else stamps
    os.makedirs(root, exist_ok=True)
    if layout == "4seasons":
        writers.write_four_seasons(root, frames, stamps,
                                   gt_positions(len(frames)))
    else:
        writers.write_euroc(root, frames, stamps, depth=depth,
                            gt_positions=gt_positions(len(frames)))
    cfg = os.path.join(root, "config.yaml")
    with open(cfg, "w") as f:
        f.write(CONFIG + extra_cfg)
    return root, cfg


class LogLines(logging.Handler):
    """Collects the rsvio logger's messages at DEBUG."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        lg = logging.getLogger("rsvio")
        self._level = lg.level
        lg.setLevel(logging.DEBUG)
        lg.addHandler(self)
        return self

    def __exit__(self, *exc):
        lg = logging.getLogger("rsvio")
        lg.removeHandler(self)
        lg.setLevel(self._level)


def timing_fields(lines, pattern=TIMING):
    return [tuple(int(g) for g in m.groups())
            for m in map(pattern.search, lines) if m]


def run(main, argv):
    with LogLines() as logs:
        rc = main(argv)
    return rc, logs.lines


def load_poses(path):
    ts, pos, quat = ttraj.load_tum(path)
    return ts, pos, quat


def rot_err(qa, qb):
    """Angle (rad) between the rotations of quaternions printed to 6
    decimals (normalized first), row by row."""
    qa = qa / np.linalg.norm(qa, axis=1, keepdims=True)
    qb = qb / np.linalg.norm(qb, axis=1, keepdims=True)
    return 4.0 * np.arcsin(np.clip(np.minimum(
        np.linalg.norm(qa - qb, axis=1), np.linalg.norm(qa + qb, axis=1))
        / 2.0, 0.0, 1.0))


def assert_traj_close(pa, pb, tol):
    ta, xa, qa = load_poses(pa)
    tb, xb, qb = load_poses(pb)
    np.testing.assert_array_equal(ta, tb)
    assert float(np.abs(xa - xb).max()) <= tol
    assert float(rot_err(qa, qb).max()) <= tol


def assert_same_file_poses(pa, pb):
    """Two trajectory files equal to their 6 printed decimals."""
    ta, xa, qa = load_poses(pa)
    tb, xb, qb = load_poses(pb)
    np.testing.assert_array_equal(ta, tb)
    assert float(np.abs(xa - xb).max()) <= FILE_TOL
    assert float(np.abs(qa - qb).max()) <= FILE_TOL


def direct_poses(cfg_path, frames, dtype=torch.float32, state=None,
                 **overrides):
    """The port's step driven directly over uint8 frames on the CPU: the
    pose after each frame (numpy) and the final state."""
    cfg = tconfig.load_config(cfg_path)
    ecfg, rig = tconfig.make_estimator_config(cfg, device="cpu")
    ecfg = ecfg._replace(**overrides)
    step = test_.make_estimator_step(ecfg)
    if state is None:
        state = test_.init_state(ecfg, dtype=dtype, device="cpu")
    poses = []
    for a, b in frames:
        state, out = step(state, rig, torch.from_numpy(a).to(dtype),
                          torch.from_numpy(b).to(dtype))
        poses.append(out.T_W_B.double().numpy())
    return poses, state


def write_poses(path, poses, stamps=STAMPS):
    ttraj.save_tum(path, stamps[:len(poses)], poses)
    return path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(str(tmp_path_factory.mktemp("euroc") / "MINI_01"))


@pytest.fixture(scope="module")
def jax_cli(tree, tmp_path_factory):
    """One run of the JAX package's run_euroc on the tree."""
    root, cfg = tree
    out = tmp_path_factory.mktemp("jax")
    traj = str(out / "traj.txt")
    rc, lines = run(jrun_euroc.main, [cfg, root, "--trajectory-out", traj,
                                      "--viewer-dir", str(out / "viz")])
    assert rc == 0
    return dict(traj=traj, lines=lines, viz=str(out / "viz"))


@pytest.fixture(scope="module")
def port_cli(tree, tmp_path_factory):
    root, cfg = tree
    out = tmp_path_factory.mktemp("port")
    traj = str(out / "traj.txt")
    rc, lines = run(trun_euroc.main, [cfg, root, "--device", "cpu",
                                      "--trajectory-out", traj,
                                      "--viewer-dir", str(out / "viz")])
    assert rc == 0
    return dict(traj=traj, lines=lines, viz=str(out / "viz"),
                result=trun_euroc.main.last_result)


def test_cli_matches_jax(jax_cli, port_cli):
    assert_traj_close(port_cli["traj"], jax_cli["traj"], POSE_TOL)
    fj, ft = timing_fields(jax_cli["lines"]), timing_fields(port_cli["lines"])
    assert len(ft) == N and ft == fj
    assert sum(f[3] for f in ft) >= 3, "BA never ran"
    kj = jax_cli["traj"].replace(".txt", "_keyframes.txt")
    kt = port_cli["traj"].replace(".txt", "_keyframes.txt")
    assert_traj_close(kt, kj, POSE_TOL)
    res = port_cli["result"]
    assert res.success and res.n_failed == 0
    assert len(res.frame_processing_times_ms) == len(res.decode_times_ms) == N


def test_cli_viewer_artifacts_match_jax(jax_cli, port_cli):
    names = sorted(os.listdir(os.path.join(jax_cli["viz"], "frames")))
    assert names == sorted(os.listdir(os.path.join(port_cli["viz"],
                                                   "frames")))
    assert any(n.startswith("stereo_left") for n in names)
    for name in ("trajectory.svg", "trajectory.txt", "poses.json",
                 "map_points.ply"):
        assert os.path.exists(os.path.join(port_cli["viz"], name)), name
    heads = [open(os.path.join(d, "map_points.ply")).read().split(
        "end_header")[0] for d in (jax_cli["viz"], port_cli["viz"])]
    assert heads[0] == heads[1]     # same vertex count


def test_cli_equals_direct_step(tree, port_cli, tmp_path):
    root, cfg = tree
    poses, _ = direct_poses(cfg, stereo_frames())
    assert_same_file_poses(port_cli["traj"],
                           write_poses(str(tmp_path / "d.txt"), poses))


@pytest.mark.parametrize("flag", ["--marginalization", "--no-marginalization"])
def test_marginalization_flag(tree, tmp_path, flag):
    """--marginalization switches the marginalized BA on; --no-... turns
    off a config file's solver.marginalization: true."""
    root, cfg = tree
    on = flag == "--marginalization"
    cfg2 = str(tmp_path / "cfg.yaml")
    with open(cfg2, "w") as f:
        f.write(CONFIG + ("" if on else "solver:\n  marginalization: true\n"))
    traj = str(tmp_path / "t.txt")
    rc, lines = run(trun_euroc.main, [cfg2, root, "--device", "cpu",
                                      flag, "--trajectory-out", traj])
    assert rc == 0
    assert any("dense prior" in ln for ln in lines) == on
    poses, state = direct_poses(cfg2, stereo_frames(),
                                use_marginalization=on)
    assert_same_file_poses(traj, write_poses(str(tmp_path / "d.txt"), poses))
    assert bool(state.marg_prior.valid) == on


def test_eval_ate_and_periodic_checkpoint(tree, port_cli, tmp_path):
    root, cfg = tree
    ckpt = str(tmp_path / "state.ckpt")
    rc, lines = run(trun_euroc.main, [cfg, root, "--device", "cpu",
                                      "--quiet", "--eval-ate",
                                      "--checkpoint-out", ckpt,
                                      "--checkpoint-every", "3"])
    assert rc == 0 and os.path.exists(ckpt)
    stats = open(os.path.join(root, "statistics.txt")).read()
    ate = float(re.search(r"ate_rmse_m: (\S+)", stats).group(1))
    _, pos, _ = load_poses(port_cli["traj"])
    want, _ = ttraj.ate_rmse(pos, gt_positions())
    assert abs(ate - want) <= 1e-5
    assert any("ATE RMSE vs ground truth" in ln for ln in lines)
    # The final checkpoint holds the state after the last frame.
    _, state = direct_poses(cfg, stereo_frames())
    loaded = tckpt.load_state(ckpt, test_.init_state(
        tconfig.make_estimator_config(tconfig.load_config(cfg),
                                      device="cpu")[0], device="cpu"))
    for (n, a), (_, b) in zip(tckpt.flatten(loaded), tckpt.flatten(state)):
        assert torch.equal(a, b), n


def test_stage_timing(tree, port_cli, tmp_path):
    root, cfg = tree
    traj = str(tmp_path / "t.txt")
    rc, lines = run(trun_euroc.main, [cfg, root, "--device", "cpu",
                                      "--stage-timing",
                                      "--trajectory-out", traj])
    assert rc == 0
    stages = [ln for ln in lines if "stages:" in ln]
    assert len(stages) == N
    assert all(all(f"{n}: " in ln for n in test_.STAGE_NAMES)
               for ln in stages)
    assert_same_file_poses(traj, port_cli["traj"])


def test_checkpoint_in_resumes(tree, port_cli, tmp_path):
    """Frames 0-3 with --checkpoint-out, then a tree of frames 4-7 with
    --checkpoint-in: the same poses as one run over all eight."""
    root, cfg = tree
    ckpt = str(tmp_path / "half.ckpt")
    assert run(trun_euroc.main, [cfg, root, "--device", "cpu", "--quiet",
                                 "--max-frames", "4",
                                 "--checkpoint-out", ckpt])[0] == 0
    tail, _ = make_tree(str(tmp_path / "tail"), stereo_frames()[4:],
                        STAMPS[4:])
    traj = str(tmp_path / "t.txt")
    assert run(trun_euroc.main, [cfg, tail, "--device", "cpu", "--quiet",
                                 "--checkpoint-in", ckpt,
                                 "--trajectory-out", traj])[0] == 0
    full = load_poses(port_cli["traj"])
    part = load_poses(traj)
    np.testing.assert_array_equal(part[0], full[0][4:])
    assert float(np.abs(part[1] - full[1][4:]).max()) <= FILE_TOL
    assert float(np.abs(part[2] - full[2][4:]).max()) <= FILE_TOL


def test_precision_f64(tmp_path):
    root, cfg = make_tree(str(tmp_path / "f64"),
                          extra_cfg="precision: f64\n")
    traj, ckpt = str(tmp_path / "t.txt"), str(tmp_path / "s.ckpt")
    rc, lines = run(trun_euroc.main, [cfg, root, "--device", "cpu",
                                      "--trajectory-out", traj,
                                      "--checkpoint-out", ckpt])
    assert rc == 0 and any("precision: f64" in ln for ln in lines)
    poses, _ = direct_poses(cfg, stereo_frames(), dtype=torch.float64)
    assert_same_file_poses(traj, write_poses(str(tmp_path / "d.txt"), poses))
    with np.load(ckpt) as data:
        names = json.loads(bytes(data["__fields__"]).decode())
        assert data[f"leaf_{names.index('T_W_B')}"].dtype == np.float64


@pytest.mark.parametrize("layout", ["tum", "4seasons"])
def test_tum_and_4seasons_layouts(port_cli, tmp_path, layout):
    """The same frames in the TUM-VI layout (16-bit PNGs) and the 4Seasons
    layout (times.txt, GNSSPoses.txt) give the EuRoC run's trajectory."""
    root, cfg = make_tree(str(tmp_path / layout),
                          depth=16 if layout == "tum" else 8,
                          layout="euroc" if layout == "tum" else layout)
    main = trun_tum.main if layout == "tum" else trun_4seasons.main
    traj = str(tmp_path / "t.txt")
    rc, lines = run(main, [cfg, root, "--device", "cpu", "--quiet",
                           "--eval-ate", "--trajectory-out", traj])
    assert rc == 0 and main.last_result.n_failed == 0
    assert_same_file_poses(traj, port_cli["traj"])
    assert "ate_rmse_m" in open(os.path.join(root, "statistics.txt")).read()


# ------------------------------------------------------------------- mono

def mono_tree(root, n=6, h=240, w=320):
    base = texture(h + 2 * n, w + 4 * n, seed=3)
    imgs = [np.ascontiguousarray(base[k:k + h, 3 * k:3 * k + w])
            for k in range(n)]
    return writers.write_tartanair(root, imgs), imgs


@pytest.mark.parametrize("yaml", [None, "tartanair.yaml"])
def test_tartanair(tmp_path, yaml):
    root, imgs = mono_tree(str(tmp_path / "seq"))
    args = [root, "--capacity", "64", "--levels", "3"]
    if yaml:
        args += ["--config", os.path.join(CONFIG_DIR, yaml)]
    rc, lines = run(trun_tartanair.main, args + ["--device", "cpu"])
    assert rc == 0
    got = timing_fields(lines, MONO)
    res = trun_tartanair.main.last_result
    assert [(k, t, a) for k, (t, a) in enumerate(zip(res.tracked,
                                                     res.alive))] == got
    # The port's tracker driven directly.
    cfg, make_pyr = trun_tartanair.tracker_settings(
        args[-1] if yaml else None, 3, 64)
    table = tmono.init_mono_table(64, device="cpu")
    prev, want = None, []
    for k, img in enumerate(imgs):
        pyr = make_pyr(torch.from_numpy(img).float())
        table, st = tmono.mono_tracker_step(
            table, pyr if prev is None else prev, pyr, cfg,
            first_frame=prev is None)
        prev = pyr
        want.append((k, int(st["tracked"]), int(st["alive"])))
    assert got == want and want[-1][1] >= 20
    # The JAX CLI (gather route on the CPU): counts within TRACK_COUNT_TOL.
    rc, jl = run(jrun_tartanair.main, args)
    assert rc == 0
    jgot = timing_fields(jl, MONO)
    assert [k for k, _, _ in jgot] == [k for k, _, _ in got]
    for (_, t, a), (_, tj, aj) in zip(got, jgot):
        assert abs(t - tj) <= TRACK_COUNT_TOL and abs(a - aj) <= \
            TRACK_COUNT_TOL, (got, jgot)


def test_profile_realtime_and_step_mode(tree, tmp_path):
    """--profile-dir writes a torch.profiler Chrome trace; --realtime paces
    frames to their 50 ms stamps; --step-mode with no keyboard (stdin
    closed) quits after the first frame, as the JAX controller does."""
    root, cfg = tree
    prof = tmp_path / "prof"
    rc, lines = run(trun_euroc.main, [cfg, root, "--device", "cpu",
                                      "--quiet", "--max-frames", "3",
                                      "--realtime", "--profile-dir",
                                      str(prof)])
    assert rc == 0
    assert len(trun_euroc.main.last_result.frame_processing_times_ms) == 3
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    rc, lines = run(trun_euroc.main, [cfg, root, "--device", "cpu",
                                      "--quiet", "--step-mode"])
    assert rc == 0 and any("quit at frame 0" in ln for ln in lines)
    assert len(trun_euroc.main.last_result.frame_processing_times_ms) == 1


# ------------------------------------------------------- refusals, failures

def test_vio_and_missing_gpu_raise(tree, monkeypatch, tmp_path):
    """--vio runs on a tree with an IMU csv (bootstrapped from its static
    head); on a tree without one it warns and runs VO; --device cuda
    without a GPU raises."""
    root, cfg = tree
    rc, lines = run(trun_euroc.main, [cfg, root, "--device", "cpu", "--vio",
                                      "--max-frames", "3"])
    assert rc == 0
    assert sum("VIO requested but no IMU data found; running VO" in ln
               for ln in lines) == 1
    assert len(timing_fields(lines)) == 3
    step = 5_000_000
    imu_ts = np.arange(STAMPS[0] - 100 * step, STAMPS[-1] + 1, step)
    imu = np.zeros((len(imu_ts), 7))
    imu[:, 0], imu[:, 6] = imu_ts, 9.81
    vio_root = str(tmp_path / "vio")
    writers.write_euroc(vio_root, stereo_frames(), STAMPS,
                        gt_positions=gt_positions(), imu=imu)
    traj = str(tmp_path / "vio.txt")
    rc, lines = run(trun_euroc.main, [cfg, vio_root, "--device", "cpu",
                                      "--vio", "--trajectory-out", traj])
    assert rc == 0
    assert any(ln.startswith("VIO mode: ") for ln in lines)
    assert any("gravity-aligned" in ln for ln in lines)
    assert not any("no IMU data" in ln for ln in lines)
    assert len(load_poses(traj)[0]) == N
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((trun_euroc.main, [cfg, root]),
                       (trun_tartanair.main, [root])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--device", "cuda"])


def test_gather_route_and_viewer_warnings(tree, tmp_path):
    root, cfg = tree
    cfg2 = str(tmp_path / "xla.yaml")
    with open(cfg2, "w") as f:
        f.write(CONFIG.replace("backend: pallas", "backend: xla"))
    rc, lines = run(trun_euroc.main, [cfg2, root, "--device", "cpu",
                                      "--max-frames", "2", "--viewer"])
    assert rc == 0
    assert any("gather path" in ln for ln in lines)
    assert sum("rerun SDK" in ln for ln in lines) == 1
    rc, lines = run(trun_euroc.main, [cfg, root, "--device", "cpu",
                                      "--max-frames", "2"])
    assert not any("gather path" in ln for ln in lines)


def test_bad_frame_skipped_and_kernel_failure_raised(tmp_path, monkeypatch):
    frames = stereo_frames(5)
    frames[2] = (frames[2][0][:, :-8].copy(), frames[2][1])
    root, cfg = make_tree(str(tmp_path / "bad"), frames)
    rc, lines = run(trun_euroc.main, [cfg, root, "--device", "cpu",
                                      "--quiet"])
    res = trun_euroc.main.last_result
    assert rc == 0 and res.n_failed == 1
    assert len(res.frame_processing_times_ms) == 4
    assert any("frame 2 failed" in ln for ln in lines)
    # A decode error stops the run and keeps the frames before it.
    os.remove(os.path.join(root, "mav0", "cam1", "data", f"{STAMPS[3]}.png"))
    rc, _ = run(trun_euroc.main, [cfg, root, "--device", "cpu", "--quiet"])
    res = trun_euroc.main.last_result
    assert rc == 0 and res.n_failed == 2
    assert len(res.frame_processing_times_ms) == 2
    # A failure of the kernel layer is raised, not skipped.
    make_step = test_.make_estimator_step

    def failing(cfg, **kw):
        step = make_step(cfg, **kw)

        def f(state, rig, a, b):
            if int(state.frame_id) == 1:
                raise KernelError("klt_bidir launch failed with code 1")
            return step(state, rig, a, b)
        return f

    monkeypatch.setattr(test_, "make_estimator_step", failing)
    with pytest.raises(KernelError):
        trun_euroc.main([cfg, root, "--device", "cpu", "--quiet"])
    shutil.rmtree(root)
