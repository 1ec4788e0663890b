"""The port's VIO step (models/estimator_vio.py) against the JAX package's.

Setup: tests/test_torch_estimator.py's tiny scene and configuration (96x128,
32 slots, 3 levels, window 4; the JAX step's Pallas KLT in interpret mode)
driven by its rolling-image stereo sequence, with the hover IMU buffer of
tests/test_estimator_vio.py (16 slots, 10 samples of accel (0, 0, +9.81)
and zero rate at 200 Hz a frame), ``VIOBAConfig(max_iterations=10)``.
Both run on the CPU in float32.

Tolerances:
  * per frame: keyframe / PnP / BA flags and the track, landmark and
    occupancy counts equal. Poses within 3e-3 m / rad, velocity within
    1e-2 m/s, biases within 5e-3. The float32 joint solve stops on its
    iteration cap at float32's resolution (tests/test_torch_vio_ba.py), so
    the trajectory carries that much noise in JAX itself: over this
    sequence JAX's float32 poses sit up to 1.2e-3 m and its accel bias
    2e-3 from the port's float64 run of the same frames (measured), where
    the port's float32 run sits up to 7.6e-4 m. (ROADMAP C.)
  * one step from a converted JAX state on a frame without a keyframe:
    integer and boolean fields equal, floats within 1e-4.
  * the CLI's --vio trajectory against the port's step driven directly on
    the same decoded frames and IMU buffers: the trajectory file's 6
    decimals.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import estimator_vio as jev
from rsvio_tpu.models import vio_ba as jvb
from rsvio_tpu.utils import checkpoint as jckpt
from rsvio_tpu.utils import config as jcfg
from rsvio_tpu_torch.cli import run as trun
from rsvio_tpu_torch.cli import run_euroc as trun_euroc
from rsvio_tpu_torch.data import players, writers
from rsvio_tpu_torch.models import estimator_vio as tev
from rsvio_tpu_torch.models import vio_ba as tvb
from rsvio_tpu_torch.utils import checkpoint as tckpt
from rsvio_tpu_torch.utils import config as tcfg
from rsvio_tpu_torch.utils import convert
from rsvio_tpu_torch.utils import trajectory as ttraj
from test_torch_estimator import (FLAGS, _frames, _jax_cfg, _jax_rig, _np,
                                  _pose_err, _torch_cfg)

torch.set_num_threads(2)

POSE_TOL = 3e-3
VEL_TOL = 1e-2
BIAS_TOL = 5e-3
STEP_TOL = 1e-4
S_BUF = 16
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config")
SHIPPED = sorted(os.listdir(CONFIG_DIR))


def imu_buffer(n=10, s=S_BUF):
    """Constant-velocity hover IMU: accel (0, 0, +g) in the body, no
    rate; the first n of s samples valid."""
    gyro = np.zeros((s, 3), np.float32)
    accel = np.zeros((s, 3), np.float32)
    accel[:, 2] = 9.81
    dts = np.full(s, 1.0 / 200.0, np.float32)
    mask = np.zeros(s, bool)
    mask[:n] = True
    return gyro, accel, dts, mask


def vio_cfgs(**base):
    """(JAX, port) VIOEstimatorConfig on the tiny base config."""
    pnp = base.pop("pnp", {})
    vio = base.pop("vio", {})
    out = []
    for mod, vb, c in ((jev, jvb, _jax_cfg()), (tev, tvb, _torch_cfg())):
        c = c._replace(pnp=c.pnp._replace(**pnp), **base)
        out.append(mod.VIOEstimatorConfig(
            base=c, imu_buf=S_BUF,
            vio=vb.VIOBAConfig(max_iterations=10, **vio)))
    return out


def jax_draws(n, k_hyp, n_cap=32):
    base = jax.random.PRNGKey(0x5A11AC)
    return [np.array(jax.random.gumbel(jax.random.fold_in(base, k),
                                         (k_hyp, 2 * n_cap),
                                         dtype=jnp.float32))
            for k in range(n)]


def run_jax(cfg_j, buf):
    """JAX states (numpy) before each frame and outputs of each frame."""
    step = jev.make_vio_estimator_step(cfg_j)
    rig = _jax_rig()
    state = jev.init_vio_state(cfg_j)
    states, outs = [_np(state)], []
    jb = tuple(jnp.asarray(x) for x in buf)
    for a, b in _frames():
        state, out = step(state, rig, jnp.asarray(a), jnp.asarray(b), *jb)
        states.append(_np(state))
        outs.append(_np(out))
    return dict(rig=_np(rig), states=states, outs=outs)


def torch_step(cfg_t, draws=None):
    if draws is None:
        return tev.make_vio_estimator_step(cfg_t)
    return tev.make_vio_estimator_step(
        cfg_t, draws=lambda fid, shape, dtype, device:
        torch.from_numpy(draws[fid]).to(dtype=dtype, device=device))


def assert_sequence_matches(cfg_t, jr, buf, step=None):
    """The port's step over the frames from the initial state against
    the JAX run jr; returns the final port state."""
    step = step or torch_step(cfg_t)
    rig = convert.rig_from_numpy(jr["rig"], device="cpu")
    state = tev.init_vio_state(cfg_t, device="cpu")
    saw_ba = False
    for k, (a, b) in enumerate(_frames()):
        state, out = step(state, rig, torch.from_numpy(a),
                          torch.from_numpy(b), *buf)
        oj, sj = jr["outs"][k], jr["states"][k + 1]
        for f in FLAGS:
            assert int(getattr(out, f)) == int(getattr(oj, f)), (k, f)
        dt, dr = _pose_err(out.T_W_B.numpy(), oj.T_W_B)
        assert dt <= POSE_TOL and dr <= POSE_TOL, (k, dt, dr)
        np.testing.assert_allclose(state.vel.numpy(), sj.vel, atol=VEL_TOL)
        for f in ("bg", "ba"):
            np.testing.assert_allclose(getattr(state, f).numpy(),
                                       getattr(sj, f), atol=BIAS_TOL,
                                       err_msg=f"{k} {f}")
        assert int(state.buf_count) == int(sj.buf_count)
        np.testing.assert_array_equal(state.kf_preint_valid.numpy(),
                                      sj.kf_preint_valid)
        saw_ba = saw_ba or bool(out.ba_success)
    assert saw_ba and int(out.n_tracked) >= 10
    return state


@pytest.fixture(scope="module")
def jax_default():
    return run_jax(vio_cfgs()[0], imu_buffer())


@pytest.fixture(scope="module")
def jax_marg():
    return run_jax(vio_cfgs(use_marginalization=True)[0], imu_buffer())


def test_config_state_and_stage_fields_equal():
    for cj, ct in ((jev.VIOEstimatorConfig, tev.VIOEstimatorConfig),
                   (jev.VIOEstimatorState, tev.VIOEstimatorState),
                   (jev.VIOFrontOut, tev.VIOFrontOut),
                   (jev.VIOKFPrep, tev.VIOKFPrep),
                   (jev.VIOStages, tev.VIOStages)):
        assert cj._fields == ct._fields, cj.__name__
    dj, dt = jev.VIOEstimatorConfig(), tev.VIOEstimatorConfig()
    assert (dj.imu_buf, dj.interval_buf) == (dt.imu_buf, dt.interval_buf)
    assert dj.imu_params._asdict() == dt.imu_params._asdict()
    assert dj.vio._asdict() == dt.vio._asdict()


def test_sequence_matches_jax(jax_default):
    cfg_t = vio_cfgs()[1]
    state = assert_sequence_matches(cfg_t, jax_default, imu_buffer())
    assert float(state.vel[0]) > 0.1, "the velocity estimate must move"


def test_marginalized_sequence_matches_jax(jax_marg):
    cfg_t = vio_cfgs(use_marginalization=True)[1]
    state = assert_sequence_matches(cfg_t, jax_marg, imu_buffer())
    assert bool(state.marg_prior.valid) and \
        bool(jax_marg["states"][-1].marg_prior.valid)
    np.testing.assert_allclose(
        state.marg_prior.T0.numpy(), jax_marg["states"][-1].marg_prior.T0,
        atol=POSE_TOL)


def _compare_states(st, sj):
    """Field by field: integer / bool exact, floats within STEP_TOL."""
    def cmp(name, t, j):
        if j is None:
            assert t is None, name
            return
        t = np.asarray(t)
        assert t.shape == j.shape, name
        if j.dtype.kind in "biu":
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, atol=STEP_TOL, rtol=STEP_TOL,
                                       err_msg=name)
    for f in tev.VIOEstimatorState._fields:
        t, j = getattr(st, f), getattr(sj, f)
        if f in ("table", "marg_prior", "kf_preint"):
            for g in type(t)._fields:
                cmp(f"{f}.{g}", getattr(t, g), getattr(j, g))
        elif f in ("pyr0", "pyr1"):
            for lvl, (a, b) in enumerate(zip(t, j)):
                cmp(f"{f}[{lvl}]", a, b)
        elif f in ("buf_gyro", "buf_accel", "buf_dts"):
            # Only the buffer's live slots carry data.
            n = int(np.asarray(getattr(sj, "buf_count")))
            cmp(f, np.asarray(t)[:n], j[:n])
        else:
            cmp(f, t, j)


def test_one_step_from_converted_state(jax_default):
    """The port from JAX's state before a frame without a keyframe (after
    the window filled), stepped once, against JAX's state after it."""
    outs = jax_default["outs"]
    ks = [k for k in range(4, len(outs)) if not bool(outs[k].is_keyframe)]
    assert ks, "the sequence has no frame without a keyframe"
    k = ks[0]
    cfg_t = vio_cfgs()[1]
    state = convert.vio_state_from_numpy(jax_default["states"][k],
                                         device="cpu")
    rig = convert.rig_from_numpy(jax_default["rig"], device="cpu")
    a, b = _frames()[k]
    new, out = torch_step(cfg_t)(state, rig, torch.from_numpy(a),
                                 torch.from_numpy(b), *imu_buffer())
    for f in FLAGS:
        assert int(getattr(out, f)) == int(getattr(outs[k], f)), f
    _compare_states(convert.vio_state_to_numpy(new),
                    jax_default["states"][k + 1])


def test_vio_state_convert_round_trip(jax_marg):
    sj = jax_marg["states"][-1]
    st = convert.vio_state_from_numpy(sj, device="cpu")
    assert st.kf_preint.dR.shape == (3, 3, 3)
    assert st.marg_prior.H.shape == (60, 60) and st.marg_prior.valid.dtype \
        == torch.bool
    assert st.lm_birth is None and st.kf_bias_alpha is None
    _compare_states(convert.vio_state_to_numpy(st), sj)


@pytest.mark.parametrize("vio", [
    dict(bias_gyro_weight_desert=1e5),
    dict(bias_gyro_weight_desert=1e5, bias_accel_weight_desert=1e6)],
    ids=["one_weight", "no_gate"])
def test_half_configured_desert_is_refused(vio):
    """Desert stiffness needs both weights and the RANSAC gate: both
    packages refuse the config."""
    cfg_j, cfg_t = vio_cfgs(vio=vio)
    with pytest.raises(NotImplementedError):
        jev.make_vio_estimator_step(cfg_j)
    with pytest.raises(NotImplementedError):
        tev.make_vio_estimator_step(cfg_t)


def _cfg_dict(c):
    return {k: (_cfg_dict(v) if hasattr(v, "_fields") else v)
            for k, v in c._asdict().items()}


@pytest.mark.parametrize("name", SHIPPED)
def test_vio_config_and_imu_params_match_jax(name):
    """make_estimator_config(kind="vio") and make_imu_params of every
    shipped file, and the CLI's VIOBAConfig mapping, against JAX's."""
    path = os.path.join(CONFIG_DIR, name)
    ct, cj = tcfg.load_config(path), jcfg.load_config(path)
    et, rt = tcfg.make_estimator_config(ct, kind="vio", device="cpu")
    ej, rj = jcfg.make_estimator_config(cj, kind="vio")
    assert _cfg_dict(et) == _cfg_dict(ej)
    for f in rt._fields:
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    assert tcfg.make_imu_params(ct)._asdict() == \
        jcfg.make_imu_params(cj)._asdict()
    vcfg = trun.vio_config(ct, et)
    s = cj.solver
    want = jvb.VIOBAConfig(
        huber_delta=s.huber_delta, cost_tol=s.cost_tol, param_tol=s.param_tol,
        chi2_gate=s.chi2_gate, chi2_gate_iter=s.chi2_gate_iter,
        bias_gyro_weight=s.bias_gyro_weight,
        bias_accel_weight=s.bias_accel_weight,
        bias_gyro_weight_desert=s.bias_gyro_weight_desert,
        bias_accel_weight_desert=s.bias_accel_weight_desert,
        min_lm_span=s.min_lm_span)
    assert vcfg.vio._asdict() == want._asdict()
    assert vcfg.vio.max_iterations == 20


def test_checkpoint_round_trip_and_jax_file(jax_marg, tmp_path):
    """The port's VIO state through save_state / load_state, and a VIO
    checkpoint written by the JAX package loading leaf for leaf."""
    cfg_t = vio_cfgs(use_marginalization=True)[1]
    template = tev.init_vio_state(cfg_t, device="cpu")
    sj = jax_marg["states"][-1]
    st = convert.vio_state_from_numpy(sj, device="cpu")
    p = str(tmp_path / "port.ckpt")
    tckpt.save_state(p, st)
    back = tckpt.load_state(p, template)
    for (n, a), (_, b) in zip(tckpt.flatten(back), tckpt.flatten(st)):
        assert torch.equal(a, b), n
    pj = str(tmp_path / "jax.ckpt")
    jckpt.save_state(pj, jax.tree.map(jnp.asarray, sj))
    loaded = tckpt.load_state(pj, template)
    leaves_j = jax.tree.leaves(sj)
    leaves_t = tckpt.flatten(loaded)
    assert len(leaves_j) == len(leaves_t)
    for (n, t), j in zip(leaves_t, leaves_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=n)


def test_entry_points_take_a_device():
    for fn in (tev.init_vio_state, tev.initialize_vio_state,
               convert.vio_state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ------------------------------------------------------------- CLI --vio

H_C, W_C, N_C = 120, 160, 8
T0_NS = 1_403_636_579_763_555_584


def imu_rows(stamps, hz=200.0, head_s=0.5):
    """Hover IMU csv rows (ts, gyro, accel) from head_s before the first
    frame to the last, at hz."""
    step = int(round(1e9 / hz))
    ts = np.arange(stamps[0] - int(head_s * 1e9), stamps[-1] + 1, step)
    rows = np.zeros((len(ts), 7))
    rows[:, 0] = ts
    rows[:, 6] = 9.81
    return rows


def test_cli_vio_equals_direct_step(tmp_path):
    """run_euroc --vio --device cpu on a mini tree with an IMU csv against
    the port's VIO step driven directly on the same decoded frames and IMU
    buffers (with the same quasi-static bootstrap)."""
    from test_torch_cli import CONFIG, gt_positions, stereo_frames
    frames = stereo_frames(N_C, H_C, W_C)
    stamps = [T0_NS + 50_000_000 * k for k in range(N_C)]
    root = str(tmp_path / "vio")
    writers.write_euroc(root, frames, stamps, gt_positions=gt_positions(N_C),
                        imu=imu_rows(stamps))
    cfg_path = os.path.join(root, "config.yaml")
    with open(cfg_path, "w") as f:
        f.write(CONFIG)
    traj = str(tmp_path / "vio.txt")
    assert trun_euroc.main([cfg_path, root, "--device", "cpu", "--vio",
                            "--trajectory-out", traj, "--quiet"]) == 0

    cfg = tcfg.load_config(cfg_path)
    ecfg, rig = tcfg.make_estimator_config(cfg, kind="vio", device="cpu")
    vcfg = trun.vio_config(cfg, ecfg)
    player = players.EurocPlayer(root)
    samples = player.load_imu()
    imu = {"ts": np.asarray([s.timestamp_ns for s in samples]),
           "gyro": np.asarray([s.gyro for s in samples], np.float32),
           "accel": np.asarray([s.accel for s in samples], np.float32)}
    head = imu["ts"] <= imu["ts"][0] + int(0.5e9)
    assert tev.quasi_static_check(imu["gyro"][head], imu["accel"][head])[0]
    state = tev.initialize_vio_state(vcfg, imu["gyro"][head],
                                     imu["accel"][head], device="cpu")
    step = tev.make_vio_estimator_step(vcfg)
    poses, prev = [], None
    for k in range(N_C):
        fr = player.load_frame(k, as_uint8=True)
        state, out = step(state, rig, torch.from_numpy(fr.left).float(),
                          torch.from_numpy(fr.right).float(),
                          *trun._imu_buffer_for_frame(imu, prev,
                                                      fr.timestamp_ns))
        prev = fr.timestamp_ns
        poses.append(out.T_W_B.double().numpy())
    ref = str(tmp_path / "direct.txt")
    ttraj.save_tum(ref, stamps, poses)
    ta, xa, qa = ttraj.load_tum(traj)
    tb, xb, qb = ttraj.load_tum(ref)
    np.testing.assert_array_equal(ta, tb)
    assert float(np.abs(xa - xb).max()) <= 2e-6
    assert float(np.abs(qa - qb).max()) <= 2e-6
    assert np.isfinite(xa).all() and float(np.abs(xa[-1]).max()) > 0.01
