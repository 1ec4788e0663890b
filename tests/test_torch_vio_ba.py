"""The port's visual-inertial window solver against the JAX package.

Problem: a 4-keyframe window on a 6-DoF sinusoid trajectory (rotation and
translation on every axis), 24 landmarks seen in stereo, 200 Hz IMU with
constant biases preintegrated by the JAX package (both solvers get the same
``Preintegrated``), poses, velocities and landmarks perturbed.

Tolerances:
  * ``_imu_sqrt_info``: float64 within 1e-10 of JAX relative to its
    largest entry; float32 within 1e-5 of the weight cap (3e2) that
    rescales it (the inverse of a ~1e-10 covariance in float32 differs at
    rounding level).
  * ``_imu_linearize_one``: residual and Jacobians within 1e-9 (float64)
    and 1e-3 relative to the largest entry (float32) of ``jax.jacfwd``'s;
    float64 Jacobians within 1e-5 of central differences (step 1e-6).
  * ``solve_vio_ba`` / ``solve_vio_ba_marginalized``: float64 the same LM
    path (iterations, status, the accept column) and states, landmarks,
    priors within 1e-8. In float32 the joint system sits at the format's
    resolution (IMU blocks ~1e5 beside visual ones ~1e2): JAX's own float32
    solve stops on the iteration cap, 3.3e-3 m / 4.6e-3 m/s from its
    float64 optimum on this problem (ROADMAP C), and two float32
    implementations part after the first few iterations (the port's float32
    states end 2-5e-3 from that optimum, depending on rounding). So float32
    is held to the same accept column over the first 4 iterations with
    costs within 1e-4 of the first one's, to a final cost within 1e-4 of
    the initial cost from JAX's float64 final cost (as JAX's own float32
    solve is), and to states within 1e-2 of JAX's float64 optimum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import imu as jimu
from rsvio_tpu.models import marginalization as jmg
from rsvio_tpu.models import vio_ba as jvb
from rsvio_tpu.ops import lie as jlie
from rsvio_tpu_torch.models import imu as timu
from rsvio_tpu_torch.models import marginalization as tmg
from rsvio_tpu_torch.models import vio_ba as tvb

torch.set_num_threads(2)

W, L = 4, 24
KF_DT = 0.25
IMU_HZ = 200.0
BG = np.array([0.003, -0.002, 0.004])
BA = np.array([0.02, -0.015, 0.01])
DTYPES = {"f32": np.float32, "f64": np.float64}


def _rot(axis_angle):
    return np.asarray(jlie.so3_exp(jnp.asarray(axis_angle, jnp.float32)),
                      np.float64)


def _pose(t):
    """6-DoF sinusoid trajectory: T_W_B(t) (4,4) float64."""
    T = np.eye(4)
    T[:3, :3] = _rot([0.2 * np.sin(1.3 * t), 0.15 * np.sin(0.9 * t),
                      0.25 * np.sin(0.7 * t)])
    T[:3, 3] = [0.6 * np.sin(0.8 * t), 0.3 * np.sin(1.1 * t),
                0.2 * np.sin(0.6 * t)]
    return T


def _imu(t0, n):
    """n midpoint samples after t0: gyro, accel (body), with biases."""
    dt, h = 1.0 / IMU_HZ, 1e-4
    gyro, accel = np.zeros((n, 3)), np.zeros((n, 3))
    for i in range(n):
        tm = t0 + dt * (i + 0.5)
        R = _pose(tm)[:3, :3]
        Wb = R.T @ (_pose(tm + h)[:3, :3] - _pose(tm - h)[:3, :3]) / (2 * h)
        gyro[i] = [Wb[2, 1], Wb[0, 2], Wb[1, 0]]
        a_w = (_pose(tm + h)[:3, 3] - 2 * _pose(tm)[:3, 3]
               + _pose(tm - h)[:3, 3]) / (h * h)
        accel[i] = R.T @ (a_w - np.array([0.0, 0.0, -jimu.GRAVITY]))
    return gyro + BG, accel + BA


def _vel(t, h=1e-5):
    return (_pose(t + h)[:3, 3] - _pose(t - h)[:3, 3]) / (2 * h)


@pytest.fixture(scope="module")
def problem():
    """numpy arrays (float64) of the window problem and JAX's float64 and
    float32 preintegrations of its intervals."""
    rng = np.random.default_rng(7)
    T_C_B = np.stack([np.eye(4)] * 2)
    T_C_B[1, 0, 3] = -0.11
    T_gt = np.stack([_pose(KF_DT * i) for i in range(W)])
    v_gt = np.stack([_vel(KF_DT * i) for i in range(W)])
    p_gt = np.stack([rng.uniform(-2, 3, L), rng.uniform(-2, 2, L),
                     rng.uniform(3, 8, L)], axis=1)
    obs = np.zeros((W, 2, L, 2))
    mask = np.zeros((W, 2, L), bool)
    for i in range(W):
        Tbw = np.linalg.inv(T_gt[i])
        for c in range(2):
            pC = (T_C_B[c][:3, :3] @ (Tbw[:3, :3] @ p_gt.T + Tbw[:3, 3:4])
                  + T_C_B[c][:3, 3:4]).T
            ok = pC[:, 2] > 0.5
            obs[i, c, ok] = pC[ok, :2] / pC[ok, 2:3]
            mask[i, c] = ok
    obs[2, 0, 5] += 0.05          # two gross outliers for the chi^2 gate
    obs[3, 1, 9] -= 0.04
    n_s = int(KF_DT * IMU_HZ)
    imu = [_imu(KF_DT * i, n_s) for i in range(W - 1)]
    pre = {}
    for name, dt in DTYPES.items():
        with jax.enable_x64(name == "f64"):
            zb = jnp.zeros(3, dt)
            pres = [jimu.preintegrate(
                jnp.asarray(g, dt), jnp.asarray(a, dt),
                jnp.full((n_s,), 1.0 / IMU_HZ, dt), jnp.ones(n_s, bool),
                zb, zb) for g, a in imu]
            pre[name] = jax.tree.map(
                lambda *x: np.stack([np.asarray(v) for v in x]), *pres)
    T0 = T_gt.copy()
    for i in range(1, W):
        T0[i, :3, :3] = T0[i, :3, :3] @ _rot(rng.normal(size=3) * 0.01)
        T0[i, :3, 3] += rng.normal(size=3) * 0.02
    return dict(T_C_B=T_C_B, T0=T0, v0=v_gt + rng.normal(size=(W, 3)) * 0.05,
                lms0=p_gt + rng.normal(size=p_gt.shape) * 0.05, obs=obs,
                mask=mask, pre=pre, obs_w=rng.uniform(0.3, 1.0, (W, L)),
                alpha=np.array([0.0, 0.6, 1.0]))


def _jstate(p, dt):
    return jvb.VIOState(T_W_B=jnp.asarray(p["T0"], dt),
                        vel=jnp.asarray(p["v0"], dt),
                        bg=jnp.zeros((W, 3), dt), ba=jnp.zeros((W, 3), dt))


def _tstate(p, dt):
    return tvb.VIOState(T_W_B=_t(p["T0"], dt), vel=_t(p["v0"], dt),
                        bg=torch.zeros((W, 3), dtype=_TD[dt]),
                        ba=torch.zeros((W, 3), dtype=_TD[dt]))


_TD = {np.float32: torch.float32, np.float64: torch.float64}


def _tpre(pre):
    return timu.Preintegrated(*(_t(x) for x in pre))


def _t(x, dt=None):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(dt) if dt is not None else x.copy())


# ---------------------------------------------------------------- factors

@pytest.mark.parametrize("name", ["f32", "f64"])
def test_imu_sqrt_info(problem, name):
    """The whitening of each interval and of an empty one (cov 0: 1e10 I
    before the cap) against JAX."""
    dt = DTYPES[name]
    pre = problem["pre"][name]
    empty = jax.tree.map(lambda x: np.zeros_like(x[0]), pre)
    cfg_j, cfg_t = jvb.VIOBAConfig(), tvb.VIOBAConfig()
    with jax.enable_x64(name == "f64"):
        want = [np.asarray(jvb._imu_sqrt_info(
            jax.tree.map(lambda x: jnp.asarray(x[i]), pre), cfg_j))
            for i in range(W - 1)]
        want.append(np.asarray(jvb._imu_sqrt_info(
            jax.tree.map(jnp.asarray, empty), cfg_j)))
    got = tvb._imu_sqrt_info(_tpre(jax.tree.map(
        lambda x, e: np.concatenate([x, e[None]]), pre, empty)), cfg_t)
    for i, w in enumerate(want):
        g = got[i].numpy()
        assert g.dtype == dt and np.isfinite(g).all()
        if name == "f64":
            np.testing.assert_allclose(g, w, atol=1e-10 * np.abs(w).max())
        else:
            np.testing.assert_allclose(g, w, atol=1e-5 * cfg_t.imu_weight_cap)
    np.testing.assert_allclose(got[-1].numpy(),
                               cfg_t.imu_weight_cap * np.eye(9), rtol=1e-5)


@pytest.mark.parametrize("name", ["f32", "f64"])
@pytest.mark.parametrize("scaled", [False, True], ids=["base", "desert"])
def test_imu_linearize_one_matches_jacfwd(problem, name, scaled):
    """r, J_i, J_j of each interval at a perturbed state (biases off the
    linearization point) against jax.jacfwd."""
    dt = DTYPES[name]
    p = problem
    rng = np.random.default_rng(3)
    bg = (rng.normal(size=(W, 3)) * 0.01).astype(dt)
    ba = (rng.normal(size=(W, 3)) * 0.05).astype(dt)
    cfg_j = jvb.VIOBAConfig(bias_gyro_weight_desert=1e5,
                            bias_accel_weight_desert=1e6)
    cfg_t = tvb.VIOBAConfig(bias_gyro_weight_desert=1e5,
                            bias_accel_weight_desert=1e6)
    scale = np.array([[2.0, 30.0]], dt) if scaled else None
    st_t = _tstate(p, dt)._replace(bg=_t(bg), ba=_t(ba))
    for i in range(W - 1):
        with jax.enable_x64(name == "f64"):
            st_j = _jstate(p, dt)._replace(bg=jnp.asarray(bg),
                                           ba=jnp.asarray(ba))
            pre_j = jax.tree.map(lambda x: jnp.asarray(x[i]), p["pre"][name])
            want = jvb._imu_linearize_one(
                pre_j, st_j, i, cfg_j,
                bias_scale=None if scale is None else jnp.asarray(scale[0]))
            want = [np.asarray(x) for x in want]
        pre_t = timu.Preintegrated(*(_t(x[i]) for x in p["pre"][name]))
        got = tvb._imu_linearize_one(
            pre_t, st_t, i, cfg_t,
            bias_scale=None if scale is None else _t(scale[0]))
        for g, w in zip(got, want):
            g = g.numpy()
            assert g.dtype == dt
            tol = 1e-9 * max(1.0, np.abs(w).max()) if name == "f64" \
                else 1e-3 * np.abs(w).max()
            np.testing.assert_allclose(g, w, atol=tol)


def test_imu_jacobians_match_central_differences(problem):
    """float64 J_i, J_j against central differences of the whitened
    residual through _retract_state."""
    p = problem
    cfg = tvb.VIOBAConfig()
    st = _tstate(p, np.float64)
    pre = timu.Preintegrated(*(_t(x[1]) for x in p["pre"]["f64"]))
    r0, J_i, J_j = tvb._imu_linearize_one(pre, st, 1, cfg)
    sq = tvb._imu_sqrt_info(pre, cfg)
    h = 1e-6
    for k, J in ((1, J_i), (2, J_j)):
        num = torch.zeros(15, 15, dtype=torch.float64)
        for c in range(15):
            rs = []
            for s in (h, -h):
                d = torch.zeros(W, 15, dtype=torch.float64)
                d[k, c] = s
                sp = tvb._retract_state(st, d)
                rs.append(tvb._imu_whitened_residual(
                    pre, tuple(x[1] for x in sp), tuple(x[2] for x in sp),
                    cfg, sq))
            num[:, c] = (rs[0] - rs[1]) / (2 * h)
        scale = float(J.abs().max())
        assert float((num - J).abs().max()) <= 1e-5 * scale


def test_bias_desert_scales():
    alpha = np.array([-0.5, 0.0, 0.3, 1.0, 2.0], np.float32)
    for kw in (dict(bias_gyro_weight_desert=1e5,
                    bias_accel_weight_desert=1e6),
               dict(bias_gyro_weight_desert=1e5), {}):
        want = jvb.bias_desert_scales(jvb.VIOBAConfig(**kw),
                                      jnp.asarray(alpha), jnp.float32)
        got = tvb.bias_desert_scales(tvb.VIOBAConfig(**kw), _t(alpha),
                                     torch.float32)
        if want is None:
            assert got is None
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
    assert tvb.bias_desert_scales(tvb.VIOBAConfig(
        bias_gyro_weight_desert=1e5, bias_accel_weight_desert=1e6), None,
        torch.float32) is None


def test_config_and_result_fields_equal():
    assert jvb.VIOBAConfig._fields == tvb.VIOBAConfig._fields
    assert jvb.VIOBAConfig()._asdict() == tvb.VIOBAConfig()._asdict()
    for cj, ct in ((jvb.VIOState, tvb.VIOState),
                   (jvb.VIOBAResult, tvb.VIOBAResult),
                   (jimu.ImuParams, timu.ImuParams),
                   (jimu.Preintegrated, timu.Preintegrated)):
        assert cj._fields == ct._fields
    assert jimu.ImuParams()._asdict() == timu.ImuParams()._asdict()
    assert tvb.D == jvb.D == 15


# ----------------------------------------------------------------- solves

def _solve_args(p, name, extra, lib):
    dt = DTYPES[name]
    pre = p["pre"][name]
    valid = np.ones(W - 1, bool)
    if "invalid" in extra:
        valid[extra["invalid"]] = False
    kw = {}
    if lib == "jax":
        conv, st = jnp.asarray, _jstate(p, dt)
        pre = jax.tree.map(jnp.asarray, pre)
    else:
        conv, st = _t, _tstate(p, dt)
        pre = _tpre(pre)
    if extra.get("obs_weight"):
        kw["obs_weight"] = conv(p["obs_w"].astype(dt))
    if extra.get("bias_alpha"):
        kw["bias_alpha"] = conv(p["alpha"].astype(dt))
    args = (st, conv(p["T_C_B"].astype(dt)), conv(p["lms0"].astype(dt)),
            conv(p["obs"].astype(dt)), conv(p["mask"]), conv(np.ones(L, bool)),
            pre, conv(valid))
    return args, kw


def _check_result(got, want, want64=None):
    """float64 (want64 None): the same LM path and results within 1e-8.
    float32: the float32 criteria of the module docstring, against JAX's
    float32 (want) and float64 (want64) solves."""
    assert bool(got.success) == bool(want.success)
    if want64 is None:
        assert int(got.iterations) == int(want.iterations)
        assert int(got.status) == int(want.status)
        np.testing.assert_array_equal(got.metrics[:, 5].numpy(),
                                      np.asarray(want.metrics)[:, 5])
        for f in tvb.VIOState._fields:
            np.testing.assert_allclose(getattr(got.state, f).numpy(),
                                       np.asarray(getattr(want.state, f)),
                                       atol=1e-8, err_msg=f)
        np.testing.assert_allclose(got.landmarks.numpy(),
                                   np.asarray(want.landmarks), atol=1e-7)
        return
    m_t, m_j = got.metrics[:4].numpy(), np.asarray(want.metrics)[:4]
    np.testing.assert_array_equal(m_t[:, 5], m_j[:, 5])
    np.testing.assert_allclose(m_t[:, 0], m_j[:, 0], rtol=0,
                               atol=1e-4 * m_j[0, 0])
    c64, c0 = float(want64.final_cost), float(want64.initial_cost)
    for c in (float(want.final_cost), float(got.final_cost)):
        assert abs(c - c64) <= 1e-4 * c0, (c, c64, c0)
    for f in tvb.VIOState._fields:
        ref = np.asarray(getattr(want64.state, f))
        err = np.abs(getattr(got.state, f).numpy() - ref).max()
        assert err <= 1e-2, (f, err)


PRIOR_FLAGS = {
    "drop_bias": {},
    "keep_bias": dict(prior_drop_bias=False),
    "velocity_bias_only": dict(prior_velocity_bias_only=True),
    "no_visual_anchor": dict(prior_visual_anchor=False),
}


@pytest.fixture(scope="module")
def solved(problem):
    """A float64 solve of the window (JAX), as numpy: the eviction input."""
    with jax.enable_x64(True):
        args, _ = _solve_args(problem, "f64", {}, "jax")
        res = jvb.solve_vio_ba(*args)
        return jax.tree.map(np.asarray, res)


@pytest.mark.parametrize("flags", list(PRIOR_FLAGS))
def test_build_eviction_prior_matches_jax(problem, solved, flags):
    """The eviction prior at the solved window (float64), from an empty
    and from a valid incoming prior."""
    p = problem
    cfg_j = jvb.VIOBAConfig(**PRIOR_FLAGS[flags])
    cfg_t = tvb.VIOBAConfig(**PRIOR_FLAGS[flags])
    pre = p["pre"]["f64"]
    st = solved.state
    obs_w0 = p["obs_w"][0]
    with jax.enable_x64(True):
        pre0 = jax.tree.map(lambda x: jnp.asarray(x[0]), pre)
        sq0 = jvb._imu_sqrt_info(pre0, cfg_j)
        prior0 = jmg.empty_prior(W, 15, jnp.float64)
        jst = jax.tree.map(jnp.asarray, st)
        args = (jst, jnp.asarray(solved.landmarks), jnp.asarray(p["T_C_B"]),
                jnp.asarray(p["obs"][0]), jnp.asarray(p["mask"][0]), pre0,
                jnp.asarray(True), sq0)
        want1 = jvb.build_eviction_prior(*args, prior0, cfg_j,
                                         obs_w0=jnp.asarray(obs_w0))
        want1 = want1._replace(valid=jnp.asarray(True))
        want2 = jvb.build_eviction_prior(*args, want1, cfg_j)
        want = [jax.tree.map(np.asarray, w) for w in (want1, want2)]
    pre0_t = timu.Preintegrated(*(_t(x[0]) for x in pre))
    sq0_t = tvb._imu_sqrt_info(pre0_t, cfg_t)
    tst = tvb.VIOState(*(_t(x) for x in st))
    args = (tst, _t(solved.landmarks), _t(p["T_C_B"]), _t(p["obs"][0]),
            _t(p["mask"][0]), pre0_t, torch.tensor(True), sq0_t)
    got1 = tvb.build_eviction_prior(*args, tmg.empty_prior(
        W, 15, torch.float64, "cpu"), cfg_t, obs_w0=_t(obs_w0))
    got2 = tvb.build_eviction_prior(*args, got1, cfg_t)
    for g, w in zip((got1, got2), want):
        assert bool(g.valid)
        scale = max(1.0, np.abs(w.H).max())
        for f in ("H", "g", "T0", "x0_extra"):
            np.testing.assert_allclose(getattr(g, f).numpy(), getattr(w, f),
                                       atol=1e-8 * scale, err_msg=f)
    if flags == "drop_bias":
        H = got1.H.numpy().reshape(W, 15, W, 15)
        assert np.abs(H[:, 9:]).max() == 0.0 and np.abs(H[:3, :9, :3, :9]).max() > 0


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_solve_vio_ba_marginalized_matches_jax(problem, name):
    """Two marginalized solves in a row: from an empty prior (evicting),
    then with the prior it made; the result and the next prior."""
    dt = DTYPES[name]
    cfg_j, cfg_t = jvb.VIOBAConfig(chi2_gate=0.01), \
        tvb.VIOBAConfig(chi2_gate=0.01)
    runs = {}
    for n in {name, "f64"}:
        with jax.enable_x64(n == "f64"):
            args, _ = _solve_args(problem, n, {}, "jax")
            p0 = jmg.empty_prior(W, 15, DTYPES[n])
            r1, q1 = jvb.solve_vio_ba_marginalized(
                *args, p0, jnp.asarray(True), cfg_j)
            r2, q2 = jvb.solve_vio_ba_marginalized(
                *args, q1, jnp.asarray(True), cfg_j)
            runs[n] = [jax.tree.map(np.asarray, x) for x in (r1, q1, r2, q2)]
    want = runs[name]
    args, _ = _solve_args(problem, name, {}, "torch")
    p0 = tmg.empty_prior(W, 15, torch.float64 if name == "f64"
                         else torch.float32, "cpu")
    g1, h1 = tvb.solve_vio_ba_marginalized(*args, p0, torch.tensor(True),
                                           cfg_t)
    # In float32 the second solve starts from JAX's prior, so that it is
    # held as a solve and not through two float32 eviction systems.
    q1 = h1 if name == "f64" else tmg.MargPrior(*(_t(x) for x in want[1]))
    g2, h2 = tvb.solve_vio_ba_marginalized(*args, q1, torch.tensor(True),
                                           cfg_t)
    assert bool(h1.valid) and bool(h2.valid)
    for k, (gr, gp) in enumerate(((g1, h1), (g2, h2))):
        wr, wp = want[2 * k], want[2 * k + 1]
        _check_result(gr, wr, None if name == "f64" else runs["f64"][2 * k])
        if name == "f64":
            scale = max(1.0, np.abs(wp.H).max())
            for f in ("H", "g", "T0", "x0_extra"):
                np.testing.assert_allclose(getattr(gp, f).numpy(),
                                           getattr(wp, f), atol=1e-8 * scale,
                                           err_msg=f)
    # Without will_evict the prior passes through.
    _, h3 = tvb.solve_vio_ba_marginalized(*args, h1, torch.tensor(False),
                                          cfg_t)
    assert all(torch.equal(a, b) for a, b in zip(h3, h1))
