"""The port's IMU layer (models/imu.py and the IMU helpers of
models/estimator_vio.py) against the JAX package's.

Tolerances: ``preintegrate`` on random seeded samples with holes in the mask
within 1e-10 (float64) and 1e-5 (float32) of JAX relative to each field's
largest entry; its short loop (``n_steps`` = 1 + the last valid index)
bitwise equal to the whole buffer's. The residual, the attitude, the
prediction and the composition within 1e-12 (float64) of JAX;
``split_samples_by_keyframes`` and ``quasi_static_check`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import estimator_vio as jev
from rsvio_tpu.models import imu as jimu
from rsvio_tpu_torch.models import estimator_vio as tev
from rsvio_tpu_torch.models import imu as timu

torch.set_num_threads(2)

DTYPES = {"f32": np.float32, "f64": np.float64}


def samples(seed=0, S=48, holes=True):
    rng = np.random.default_rng(seed)
    gyro = rng.normal(0, 0.5, (S, 3))
    accel = rng.normal(0, 1.0, (S, 3)) + [0.3, -0.2, 9.81]
    dts = rng.uniform(0.004, 0.006, S)
    mask = rng.uniform(size=S) > (0.25 if holes else -1.0)
    mask[S - 9:] = False                       # a padded tail
    bg = rng.normal(0, 0.01, 3)
    ba = rng.normal(0, 0.05, 3)
    return gyro, accel, dts, mask, bg, ba


def _t(x, dt=None):
    x = np.asarray(x)
    return torch.from_numpy(np.array(x, dtype=dt) if dt else x.copy())


def jax_pre(arrs, dt, params=jimu.ImuParams()):
    gyro, accel, dts, mask, bg, ba = arrs
    with jax.enable_x64(dt == np.float64):
        out = jimu.preintegrate(*(jnp.asarray(x, dt) for x in
                                  (gyro, accel, dts)),
                                jnp.asarray(mask),
                                jnp.asarray(bg, dt), jnp.asarray(ba, dt),
                                params)
        return jax.tree.map(np.asarray, out)


def torch_pre(arrs, dt, params=timu.ImuParams(), n_steps=None):
    gyro, accel, dts, mask, bg, ba = arrs
    return timu.preintegrate(_t(gyro, dt), _t(accel, dt), _t(dts, dt),
                             _t(mask), _t(bg, dt), _t(ba, dt), params,
                             n_steps=n_steps)


@pytest.mark.parametrize("name", ["f32", "f64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_preintegrate_matches_jax(name, seed):
    dt = DTYPES[name]
    arrs = samples(seed)
    params = dict(gyro_noise=3e-4, accel_noise=4e-3)
    want = jax_pre(arrs, dt, jimu.ImuParams(**params))
    got = torch_pre(arrs, dt, timu.ImuParams(**params))
    rtol = 1e-10 if name == "f64" else 1e-5
    for f in jimu.Preintegrated._fields:
        g, w = getattr(got, f).numpy(), getattr(want, f)
        assert g.dtype == dt, f
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * max(np.abs(w).max(), 1e-30),
                                   err_msg=f)
    assert float(got.dt) == pytest.approx(float(arrs[2][arrs[3]].sum()),
                                          rel=1e-6)


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_short_loop_is_bitwise_the_full_loop(name):
    """n_steps = 1 + the last valid index skips only no-op samples."""
    dt = DTYPES[name]
    arrs = samples(2)
    n = int(np.flatnonzero(arrs[3])[-1]) + 1
    assert n < len(arrs[3])
    full = torch_pre(arrs, dt)
    short = torch_pre(arrs, dt, n_steps=n)
    for f in timu.Preintegrated._fields:
        assert torch.equal(getattr(full, f), getattr(short, f)), f
    empty = torch_pre((*arrs[:3], np.zeros_like(arrs[3]), *arrs[4:]), dt,
                      n_steps=0)
    want = jax_pre((*arrs[:3], np.zeros_like(arrs[3]), *arrs[4:]), dt)
    for f in timu.Preintegrated._fields:
        np.testing.assert_array_equal(getattr(empty, f).numpy(),
                                      getattr(want, f))


def _rot(rng):
    w = rng.normal(size=3) * 0.4
    with jax.enable_x64(True):
        return np.asarray(jax.scipy.linalg.expm(jnp.asarray(
            [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])))


def _pose(rng):
    T = np.eye(4)
    T[:3, :3] = _rot(rng)
    T[:3, 3] = rng.normal(size=3)
    return T


def test_imu_residual_matches_jax():
    """A batch of 3 intervals at states off the bias linearization point,
    float64, against JAX's residual of each."""
    rng = np.random.default_rng(4)
    pres = [jax_pre(samples(s, holes=False), np.float64) for s in (5, 6, 7)]
    pre_b = jax.tree.map(lambda *x: np.stack(x), *pres)
    Ti = np.stack([_pose(rng) for _ in range(3)])
    Tj = np.stack([_pose(rng) for _ in range(3)])
    vecs = [rng.normal(size=(3, 3)) * s for s in (1, 0.01, 0.05, 1, 0.01,
                                                  0.05)]
    got = timu.imu_residual(timu.Preintegrated(*(_t(x) for x in pre_b)),
                            _t(Ti), _t(vecs[0]), _t(vecs[1]), _t(vecs[2]),
                            _t(Tj), _t(vecs[3]), _t(vecs[4]), _t(vecs[5]))
    with jax.enable_x64(True):
        for i in range(3):
            want = np.asarray(jimu.imu_residual(
                jax.tree.map(jnp.asarray, pres[i]), jnp.asarray(Ti[i]),
                *(jnp.asarray(v[i]) for v in vecs[:3]), jnp.asarray(Tj[i]),
                *(jnp.asarray(v[i]) for v in vecs[3:])))
            np.testing.assert_allclose(got[i].numpy(), want, atol=1e-12)


@pytest.mark.parametrize("accel", [
    [0.0, 0.0, 9.81], [1.2, -0.7, 9.6], [3.0, 4.0, 1.0], [0.0, 9.81, 0.0],
    [0.0, 0.0, -9.81], [1e-10, 0.0, -9.81]],
    ids=["level", "tilted", "steep", "sideways", "upside_down",
         "nearly_upside_down"])
def test_attitude_from_gravity_matches_jax(accel):
    with jax.enable_x64(True):
        want = np.asarray(jimu.attitude_from_gravity(jnp.asarray(accel)))
    got = timu.attitude_from_gravity(_t(np.asarray(accel, np.float64)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    u = np.asarray(accel) / np.linalg.norm(accel)
    np.testing.assert_allclose(got.numpy() @ u, [0, 0, 1], atol=1e-9)


def test_split_samples_by_keyframes_matches_jax():
    rng = np.random.default_rng(8)
    imu_ts = np.sort(rng.integers(0, 10**9, 300))
    kf_ts = np.sort(rng.integers(0, 10**9, 7))
    for cap in (8, 64):
        want = jimu.split_samples_by_keyframes(imu_ts, kf_ts, cap)
        got = timu.split_samples_by_keyframes(imu_ts, kf_ts, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_imu_predict_and_chain_preint_match_jax():
    """_imu_predict through one interval, and _chain_preint of two
    consecutive ones (float64)."""
    rng = np.random.default_rng(9)
    a = jax_pre(samples(10, holes=False), np.float64)
    b = jax_pre(samples(11, holes=False), np.float64)
    b = b._replace(bias_gyro=a.bias_gyro, bias_accel=a.bias_accel)
    T = _pose(rng)
    v = rng.normal(size=3)
    ta, tb = (timu.Preintegrated(*(_t(x) for x in p)) for p in (a, b))
    with jax.enable_x64(True):
        ja, jb = (jax.tree.map(jnp.asarray, p) for p in (a, b))
        T_w, v_w = (np.asarray(x) for x in
                    jev._imu_predict(jnp.asarray(T), jnp.asarray(v), ja))
        ch_w = jax.tree.map(np.asarray, jev._chain_preint(ja, jb))
    T_g, v_g = tev._imu_predict(_t(T), _t(v), ta)
    np.testing.assert_allclose(T_g.numpy(), T_w, atol=1e-12)
    np.testing.assert_allclose(v_g.numpy(), v_w, atol=1e-12)
    ch_g = tev._chain_preint(ta, tb)
    for f in timu.Preintegrated._fields:
        w = getattr(ch_w, f)
        np.testing.assert_allclose(getattr(ch_g, f).numpy(), w,
                                   atol=1e-12 * max(1.0, np.abs(w).max()),
                                   err_msg=f)


def _quasi_static_cases():
    """The four windows of tests/test_estimator_vio.py's
    TestQuasiStaticCheck, plus a single-sample window."""
    rng = np.random.default_rng(0)
    static = (rng.normal(0.002, 0.005, (100, 3)),
              np.tile([0.1, -0.2, 9.80], (100, 1))
              + rng.normal(0, 0.05, (100, 3)))
    rng = np.random.default_rng(1)
    t = np.linspace(0, 0.5, 100)
    rotating = (np.stack([np.sin(8 * t), 0.4 * np.cos(5 * t),
                          np.zeros_like(t)], axis=1),
                np.tile([0.0, 0.0, 9.81], (100, 1))
                + rng.normal(0, 0.02, (100, 3)))
    accelerating = (np.zeros((100, 3)), np.tile([4.0, 0.0, 9.81], (100, 1)))
    t = np.linspace(0, 0.5, 200)
    vibrating = (np.zeros((200, 3)),
                 np.stack([2.0 * np.sin(60 * t), np.zeros_like(t),
                           9.81 + 2.0 * np.cos(60 * t)], axis=1))
    single = (np.zeros((1, 3)), np.array([[0.0, 0.0, 9.81]]))
    return {"static": (static, True), "rotating": (rotating, False),
            "accelerating": (accelerating, False),
            "vibrating": (vibrating, False), "single": (single, True)}


@pytest.mark.parametrize("case", ["static", "rotating", "accelerating",
                                  "vibrating", "single"])
def test_quasi_static_check_matches_jax(case):
    (gyro, accel), ok = _quasi_static_cases()[case]
    got = tev.quasi_static_check(gyro, accel)
    want = jev.quasi_static_check(gyro, accel)
    assert got == want and got[0] == ok


def test_initialize_vio_state_matches_jax():
    """The gravity-aligned bootstrap from a tilted static window."""
    (gyro, accel), _ = _quasi_static_cases()["static"]
    cfg_j = jev.VIOEstimatorConfig()
    want = jev.initialize_vio_state(cfg_j, gyro, accel)
    got = tev.initialize_vio_state(tev.VIOEstimatorConfig(), gyro, accel,
                                   device="cpu")
    for f in ("T_W_B", "last_kf_T_W_B", "bg", "ba", "vel"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-6,
                                   err_msg=f)
    assert got.T_W_B.dtype == torch.float32
