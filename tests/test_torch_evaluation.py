"""The port's evaluation harness (rsvio_tpu_torch/utils/evaluation.py)
against the JAX package's (rsvio_tpu/utils/evaluation.py) on the CPU.

Setup: the small geometry of tests/test_vio_init.py's end-to-end runs
(120x188, capacity 96, window 5, 3 levels, cell 24, margin 10, keyframe
thresholds 0.03), 18 frames at 10 Hz: the VO profiles on the accuracy
matrix's ``depth_6dof`` scene and trajectory, ``vio_fifo`` on
test_vio_init's own VIO scene (a plane at 2.5 m on a gentler 6-DoF
trajectory). The frames and the IMU stream (the matrix's biases and noise
densities) are the JAX package's generate_sequence output (rendered with
OpenCV), fed to both harnesses, as is one static_init_imu bootstrap. Both
run the kernel route (``backend="pallas"``): the JAX step its Pallas KLT
in interpret mode, the port's the kernels' plain versions. JAX's per-frame
outputs are recorded by wrapping its make_estimator_step /
make_vio_estimator_step (its harness keeps only the positions).

Tolerances (gaps measured on the CPU beside each):
  * vo_fifo: positions within 1e-3 m every frame (measured 1.8e-4);
    n_tracked, is_keyframe and ba_success equal every frame.
  * vo_adapt (the RANSAC gate and adaptive health, JAX's Gumbel draws
    injected through ``draws``): the same counts and flags equal every
    frame; positions within 3e-3 m (measured 2.09e-3). At 188 px the far
    backdrop's stereo disparity is ~0.9 px, so float32 triangulation of
    such a landmark differs by centimetres between the two (the frozen
    birth map 6 cm apart at frame 3); at frame 6 the gate's outlier kill,
    which verifies against that map, flips on 2 tracks and the solve moves
    by 2 mm. f32 accept / reject sits at rounding level (ROADMAP C).
  * vio_fifo: positions within 1.2e-3 m (measured 4.6e-4), the float32 VIO
    gap tests/test_torch_vio.py documents (the joint solve stops on its
    iteration cap at float32's resolution; the port's own float32 run sits
    4.3e-4 m from its float64 run here). On depth_6dof at this width the
    VIO run drifts ~40 % and float32 noise alone moves it by 8 cm (the
    port's float32 vs float64), so that scene holds no parity.
  * the configs both harnesses build (vo_dyn, vio_adapt; with and without
    RSVIO_* environment overrides): equal field for field.
  * the port's ATE, drift and skip equal (to float rounding) the JAX
    scoring formula applied to the port's own per-frame outputs, and its
    skip, mean tracked count and BA success rate those of the JAX run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.data import synthetic as jsyn
from rsvio_tpu.models import estimator as jest
from rsvio_tpu.models import estimator_vio as jev
from rsvio_tpu.utils import evaluation as jeval
from rsvio_tpu.utils.trajectory import ate_rmse as jax_ate_rmse
from rsvio_tpu_torch.data import synthetic as tsyn
from rsvio_tpu_torch.utils import evaluation as teval

torch.set_num_threads(2)

H, W = 120, 188
N_FRAMES = 18
FPS = 10.0
# Both on the kernel route: JAX's "auto" would take its gather route on
# the CPU.
SMALL = dict(capacity=96, window=5, levels=3, cell_size=24,
             detect_margin=10, translation_threshold=0.03,
             rotation_threshold=0.03, backend="pallas")
# name -> (scene, harness options)
PROFILES = {
    "vo_fifo": ("depth_6dof", dict(use_vio=False)),
    "vo_adapt": ("depth_6dof", dict(use_vio=False, motion_prior=20.0,
                                    ransac=16, adaptive=True)),
    "vio_fifo": ("plane_6dof", dict(use_vio=True)),
}
POS_TOL = {"vo_fifo": 1e-3, "vo_adapt": 3e-3, "vio_fifo": 1.2e-3}
IMU_KW = dict(gyro_bias=[0.003, -0.002, 0.004],
              accel_bias=[0.02, -0.015, 0.01], gyro_noise=1.7e-4,
              accel_noise=2.0e-3)


def _scenes():
    """name -> (JAX scene, JAX trajectory, port scene) at H x W."""
    plane = dict(depth=2.5, half_w=7.0, half_h=5.0)
    return {
        "depth_6dof": (jsyn.scene_depth_structured(H=H, W=W),
                       jsyn.traj_6dof(),
                       tsyn.scene_depth_structured(H=H, W=W, device="cpu")),
        # tests/test_vio_init.py's VIO scene: a plane at 2.5 m, where the
        # stereo disparity stays ~5 px at this width, on a gentler 6-DoF
        # trajectory.
        "plane_6dof": (
            dataclasses.replace(jsyn.scene_easy_plane(H=H, W=W), planes=[
                jsyn._frontal_plane(plane["depth"], plane["half_w"],
                                    plane["half_h"], 0)]),
            jsyn.traj_6dof(lin_amp=(0.5, 0.2, 0.15),
                           ang_amp_deg=(4.0, 3.0, 2.0)),
            dataclasses.replace(
                tsyn.scene_easy_plane(H=H, W=W, device="cpu"), planes=[
                    tsyn._frontal_plane(plane["depth"], plane["half_w"],
                                        plane["half_h"], 0,
                                        device="cpu")])),
    }


@pytest.fixture(scope="module")
def sequences():
    """name -> (the JAX sequence with IMU, the bootstrap samples, the
    port's scene)."""
    out = {}
    for name, (js, traj, ts) in _scenes().items():
        rng = np.random.default_rng(11)
        seq = jsyn.generate_sequence(js, traj, N_FRAMES, fps=FPS,
                                     imu_rate=200.0,
                                     imu_kwargs=dict(noise_rng=rng, **IMU_KW))
        gyro, accel = jeval.static_init_imu(traj, rng=rng, **IMU_KW)
        out[name] = (js, seq, gyro, accel, ts)
    return out


def _jax_draws(n, hyp, cap):
    base = jax.random.PRNGKey(0x5A11AC)
    return [np.array(jax.random.gumbel(jax.random.fold_in(base, k),
                                       (hyp, 2 * cap), dtype=jnp.float32))
            for k in range(n)]


def _run_pair(sequences, name, monkeypatch):
    scene, opts = PROFILES[name]
    jscene, seq, gyro, accel, tscene = sequences[scene]
    kw = dict(SMALL, **opts)
    vio = kw["use_vio"]
    boot = dict(init_gyro=gyro, init_accel=accel) if vio else {}
    mod, maker = (jev, "make_vio_estimator_step") if vio else \
        (jest, "make_estimator_step")
    recorded = []
    make = getattr(mod, maker)

    def recording(cfg):
        step = make(cfg)

        def f(*args):
            state, out = step(*args)
            recorded.append((int(out.n_tracked), bool(out.is_keyframe),
                             bool(out.ba_success)))
            return state, out
        return f

    with monkeypatch.context() as m:
        m.setattr(mod, maker, recording)
        jres = jeval.run_synthetic_sequence(seq, jscene, **kw, **boot)
    draws = None
    if kw.get("ransac"):
        jd = _jax_draws(N_FRAMES, kw["ransac"], kw["capacity"])
        draws = (lambda fid, shape, dtype, device:
                 torch.from_numpy(jd[fid]).to(dtype=dtype, device=device))
    tres = teval.run_synthetic_sequence(seq, tscene, **kw, **boot,
                                        device="cpu", draws=draws)
    return jres, np.array(recorded), tres


@pytest.mark.parametrize("name", list(PROFILES))
def test_run_matches_jax(sequences, name, monkeypatch):
    jres, jrec, tres = _run_pair(sequences, name, monkeypatch)
    np.testing.assert_allclose(tres.positions, jres.positions,
                               atol=POS_TOL[name], rtol=0)
    np.testing.assert_array_equal(tres.gt_positions, jres.gt_positions)
    s = tres.stats
    np.testing.assert_array_equal(s["n_tracked"], jrec[:, 0])
    np.testing.assert_array_equal(s["is_keyframe"], jrec[:, 1])
    np.testing.assert_array_equal(s["ba_success"], jrec[:, 2])
    assert tres.skip == jres.skip
    assert tres.n_tracked_mean == jres.n_tracked_mean
    assert tres.ba_success_rate == jres.ba_success_rate
    # The run did real work: the window filled and BA ran.
    assert s["is_keyframe"].sum() >= SMALL["window"]
    assert tres.ba_success_rate > 0 and tres.n_tracked_mean > 30
    if name == "vo_adapt":
        assert (s["n_pnp_candidates"] > 0).any()
        assert (s["n_ransac_inliers"] > 0).any()

    # The JAX scoring formula (rsvio_tpu/utils/evaluation.py) on the
    # port's own per-frame outputs.
    pos, gt, is_kf = tres.positions, tres.gt_positions, s["is_keyframe"]
    n = len(pos)
    fill = int(np.nonzero(np.cumsum(is_kf) >= SMALL["window"])[0][0]) + 1 \
        if is_kf.sum() >= SMALL["window"] else n // 3
    skip = min(fill, n - 5)
    rmse, _ = jax_ate_rmse(pos[skip:], gt[skip:])
    d_est = np.linalg.norm(pos[-1] - pos[skip])
    d_gt = np.linalg.norm(gt[-1] - gt[skip])
    path = np.sum(np.linalg.norm(np.diff(gt[skip:], axis=0), axis=1))
    drift = 100.0 * abs(d_est - d_gt) / max(path, 1e-9)
    assert tres.skip == skip
    assert tres.ate_rmse == pytest.approx(rmse, rel=1e-12, abs=1e-15)
    assert tres.drift_pct == pytest.approx(drift, rel=1e-12, abs=1e-15)
    assert tres.n_tracked_mean == float(s["n_tracked"][skip:].mean())


def _flat(cfg, prefix=""):
    """A (nested) config NamedTuple as {dotted field: value}."""
    out = {}
    for k, v in cfg._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


class _Built(Exception):
    pass


def _configs(vio, monkeypatch, **kw):
    """The configs JAX's harness and the port's build (each caught at its
    step maker, before any frame runs)."""
    from rsvio_tpu_torch.models import estimator as test_
    from rsvio_tpu_torch.models import estimator_vio as tev
    got = {}
    seq = {"frames": [None] * 6, "ts": np.arange(6) / FPS,
           "imu_ts": np.zeros(0), "gyro": np.zeros((0, 3)),
           "accel": np.zeros((0, 3)), "imu_dts": np.zeros(0)}
    name = "make_vio_estimator_step" if vio else "make_estimator_step"
    for side, mod, run, scene, dev in (
            ("jax", jev if vio else jest, jeval, jsyn.scene_occlusion(H=H, W=W),
             {}),
            ("port", tev if vio else test_, teval,
             tsyn.scene_occlusion(H=H, W=W, device="cpu"),
             {"device": "cpu"})):

        def catch(cfg, *a, side=side, **k):
            got[side] = cfg
            raise _Built
        with monkeypatch.context() as m:
            m.setattr(mod, name, catch)
            with pytest.raises(_Built):
                run.run_synthetic_sequence(seq, scene, use_vio=vio, **kw,
                                           **dev)
    return _flat(got["jax"]), _flat(got["port"])


@pytest.mark.parametrize("env", [
    {}, {"RSVIO_CHI2_PX": "3.5", "RSVIO_RANSAC": "8",
         "RSVIO_OBS_WEIGHTS": "0", "RSVIO_DYNFLOW_CENTER": "1",
         "RSVIO_BIAS_AW": "5e3", "RSVIO_HEALTH_LO": "0.4"}],
    ids=["defaults", "overrides"])
@pytest.mark.parametrize("profile", ["vo_dyn", "vio_adapt"])
def test_configs_equal_jax(profile, env, monkeypatch):
    """The harness builds JAX's EstimatorConfig / VIOEstimatorConfig field
    for field from the scene, the profile and the RSVIO_* environment
    overrides."""
    from rsvio_tpu_torch.tools.accuracy_matrix import CONFIGS
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(SMALL, **dict(CONFIGS)[profile])
    vio = kw.pop("use_vio")
    j, t = _configs(vio, monkeypatch, **kw)
    assert j == t


def test_static_init_imu_equals_jax():
    """The bootstrap samples, with biases and noise from one seed, are
    JAX's exactly (the same host numpy on a copied Trajectory)."""
    for tilt in (False, True):
        jt, tt = jsyn.traj_6dof(), tsyn.traj_6dof()
        if tilt:
            jt = jsyn.tilted(jt, roll_deg=15.0, pitch_deg=-10.0)
            tt = tsyn.tilted(tt, roll_deg=15.0, pitch_deg=-10.0)
        j = jeval.static_init_imu(jt, rng=np.random.default_rng(3), **IMU_KW)
        t = teval.static_init_imu(tt, rng=np.random.default_rng(3), **IMU_KW)
        for a, b in zip(t, j):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        j0 = jeval.static_init_imu(jt, seconds=0.2, rate=100.0)
        t0 = teval.static_init_imu(tt, seconds=0.2, rate=100.0)
        for a, b in zip(t0, j0):
            np.testing.assert_array_equal(a, b)


def test_frame_imu_buffers_slice_as_jax(sequences):
    """The per-frame IMU slicing (evaluation.py's frame_imu in JAX): the
    samples in (ts[k-1], ts[k]], capped at imu_buf, zero-padded."""
    seq = sequences["depth_6dof"][1]
    for buf in (64, 8):
        bufs = teval.frame_imu_buffers(seq, buf)
        assert len(bufs) == N_FRAMES
        ts, its = seq["ts"], seq["imu_ts"]
        for k, (gy, ac, dt, mk) in enumerate(bufs):
            lo = ts[k - 1] if k else ts[0] - (ts[1] - ts[0])
            sel = np.nonzero((its > lo) & (its <= ts[k]))[0][:buf]
            assert mk.sum() == len(sel) and mk[:len(sel)].all()
            np.testing.assert_array_equal(gy[:len(sel)], seq["gyro"][sel])
            np.testing.assert_array_equal(ac[:len(sel)], seq["accel"][sel])
            np.testing.assert_array_equal(dt[:len(sel)],
                                          seq["imu_dts"][sel])
            assert not gy[len(sel):].any() and not dt[len(sel):].any()


def test_harness_defaults_to_cuda():
    """run_synthetic_sequence runs on the card unless asked for the CPU;
    without a card the default raises."""
    import inspect
    sig = inspect.signature(teval.run_synthetic_sequence)
    assert sig.parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        seq = {"frames": [(np.zeros((H, W), np.float32),) * 2] * 6,
               "ts": np.arange(6) / FPS,
               "gt_T_W_B": np.tile(np.eye(4), (6, 1, 1))}
        with pytest.raises((AssertionError, RuntimeError)):
            teval.run_synthetic_sequence(
                seq, tsyn.scene_easy_plane(H=H, W=W, device="cpu"), **SMALL)
