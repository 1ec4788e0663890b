"""Parity of the port's solvers and table bookkeeping with the JAX package:
``solve_pnp`` and ``solve_ba`` on the synthetic forward-model problems of
tests/test_pnp.py and tests/test_ba.py (ground truth -> project -> perturb ->
optimize), also with per-observation weights and the PnP motion prior's
run-time scale, the Schur step on an indefinite reduced system, and the
frontend's ``birth_slots`` / ``masked_row_scatter``.

Each solver case runs twice.

* float32, the port's working precision: equal success flags, poses within
  1e-4 and landmarks within 1e-3 relative.
* float64 (``jax.enable_x64`` on the JAX side, float64 tensors on the
  port's): the LM path must be the same — equal iteration counts, statuses,
  success flags and accept columns, metrics rows within 1e-6 relative
  (the gain ratio within 1e-4, a ratio of two small differences). In
  float32 the last accept/reject decisions compare costs that differ by
  about the rounding of their sums, which the two sides take in another
  order, so there the path may end one or two iterations apart; float64
  puts that noise 1e9 times further below the LM tolerances. The weighted
  and prior-scaled cases hold float64 poses within 1e-9. Observations
  carry ~1 px of noise so that the optimum's cost is far above zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import ba as jba
from rsvio_tpu.models import frontend as jfe
from rsvio_tpu.models import pnp as jpnp
from rsvio_tpu.ops import lie as jlie
from rsvio_tpu_torch.models import ba as tba
from rsvio_tpu_torch.models import frontend as tfe
from rsvio_tpu_torch.models import pnp as tpnp

torch.set_num_threads(2)


def tt(x):
    return torch.from_numpy(np.array(x))


def stereo_rig():
    T = np.stack([np.eye(4, dtype=np.float32)] * 2)
    T[1, 0, 3] = -0.11
    return T


def pnp_problem(n_lm=40, pose_noise=0.05, seed=21):
    """tests/test_pnp.py's make_problem, as numpy arrays."""
    rng = np.random.default_rng(seed)
    T_C_B = stereo_rig()
    w = rng.normal(size=3) * 0.2
    t = rng.normal(size=3) * 0.5
    T_gt = np.array(jlie.se3_from_rt(jlie.so3_exp(jnp.asarray(w, jnp.float32)),
                                     jnp.asarray(t, jnp.float32)))
    T_B_W = np.array(jlie.se3_inverse(T_gt))
    p_B = np.stack([rng.uniform(-1.5, 1.5, n_lm), rng.uniform(-1.0, 1.0, n_lm),
                    rng.uniform(2.0, 6.0, n_lm)], axis=1).astype(np.float32)
    p_W = (p_B @ T_gt[:3, :3].T + T_gt[:3, 3]).astype(np.float32)
    obs = np.zeros((2, n_lm, 2), np.float32)
    mask = np.zeros((2, n_lm), bool)
    for c in range(2):
        pC = (p_W @ T_B_W[:3, :3].T + T_B_W[:3, 3]) @ T_C_B[c, :3, :3].T \
            + T_C_B[c, :3, 3]
        ok = pC[:, 2] > 0.1
        obs[c, ok] = pC[ok, :2] / pC[ok, 2:3]
        mask[c] = ok
    dw = rng.normal(size=3) * pose_noise
    dt = rng.normal(size=3) * pose_noise
    T_init = np.array(jlie.se3_from_rt(
        jnp.asarray(T_gt[:3, :3]) @ jlie.so3_exp(jnp.asarray(dw, jnp.float32)),
        jnp.asarray(T_gt[:3, 3] + dt, jnp.float32)))
    return T_init, T_C_B, p_W, obs, mask, T_gt


def ba_problem(seed=0, w=5, n_lm=24, pose_noise=0.02, lm_noise=0.05,
               rot_noise=0.01):
    """tests/test_ba.py's make_problem, as numpy arrays."""
    rng = np.random.default_rng(seed)
    T_C_B = stereo_rig()
    poses = []
    for i in range(w):
        R = jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.05, jnp.float32))
        poses.append(np.array(jlie.se3_from_rt(
            R, jnp.asarray([0.3 * i, 0.02 * i, 0.0], jnp.float32))))
    T_gt = np.stack(poses)
    p_W = np.stack([rng.uniform(-2, 2 + 0.3 * w, n_lm),
                    rng.uniform(-2, 2, n_lm),
                    rng.uniform(3.0, 8.0, n_lm)], axis=1).astype(np.float32)
    obs = np.zeros((w, 2, n_lm, 2), np.float32)
    mask = np.zeros((w, 2, n_lm), bool)
    for i in range(w):
        T_B_W = np.array(jlie.se3_inverse(T_gt[i]))
        for c in range(2):
            pC = (p_W @ T_B_W[:3, :3].T + T_B_W[:3, 3]) @ T_C_B[c, :3, :3].T \
                + T_C_B[c, :3, 3]
            ok = pC[:, 2] > 0.5
            obs[i, c, ok] = pC[ok, :2] / pC[ok, 2:3]
            mask[i, c] = ok
    init = [T_gt[0]]
    for i in range(1, w):
        dR = jlie.so3_exp(jnp.asarray(rng.normal(size=3) * rot_noise,
                                      jnp.float32))
        dt = rng.normal(size=3) * pose_noise
        init.append(np.array(jlie.se3_from_rt(
            jnp.asarray(T_gt[i, :3, :3]) @ dR,
            jnp.asarray(T_gt[i, :3, 3] + dt, jnp.float32))))
    lms = (p_W + rng.normal(size=p_W.shape) * lm_noise).astype(np.float32)
    return (np.stack(init), T_C_B, lms, obs, mask, np.ones(n_lm, bool), T_gt,
            p_W)


DTYPES = {"f32": np.float32, "f64": np.float64}


def _run(dtype, fn_j, fn_t, arrays, *cfgs, **kw):
    """Run the JAX and the port's solver on the same arrays in `dtype`."""
    arrays = [a.astype(DTYPES[dtype]) if a.dtype.kind == "f" else a
              for a in arrays]
    with jax.enable_x64(dtype == "f64"):
        rj = fn_j(*(jnp.asarray(a) for a in arrays), cfgs[0],
                  **{k: jnp.asarray(v.astype(DTYPES[dtype]))
                     for k, v in kw.items()})
        rj = jax.tree_util.tree_map(np.asarray, rj)
    rt = fn_t(*(tt(a) for a in arrays), cfgs[1],
              **{k: tt(v.astype(DTYPES[dtype])) for k, v in kw.items()})
    assert rt.T_W_B.dtype == (torch.float64 if dtype == "f64"
                              else torch.float32)
    return rt, rj


def _check(rt, rj, dtype):
    assert bool(rt.success) == bool(rj.success)
    tol = 1e-4 if dtype == "f32" else 1e-6
    np.testing.assert_allclose(rt.T_W_B.numpy(), rj.T_W_B, atol=tol, rtol=0)
    if dtype == "f64":
        assert int(rt.iterations) == int(rj.iterations)
        assert int(rt.status) == int(rj.status)
        mt, mj = rt.metrics.numpy(), rj.metrics
        np.testing.assert_array_equal(mt[:, 5], mj[:, 5])     # accepted
        cols = [0, 1, 2, 3]       # cost, gradient norm, lambda, step norm
        np.testing.assert_allclose(mt[:, cols], mj[:, cols], rtol=1e-6,
                                   atol=1e-12)
        # Gain ratio: a ratio of two small differences of near-equal costs
        # once converged, so rounding shows at ~1e-5 relative.
        np.testing.assert_allclose(mt[:, 4], mj[:, 4], rtol=1e-4, atol=1e-9)


def _noisy(obs, mask, seed, sigma=2e-3):
    """~1 px of observation noise, so the optimum's cost is far above 0."""
    rng = np.random.default_rng(seed)
    return np.where(mask[..., None],
                    obs + rng.normal(size=obs.shape) * sigma,
                    obs).astype(np.float32)


PNP_CASES = [
    dict(),                                         # tests/test_pnp default
    dict(pose_noise=0.15, seed=3),                  # larger perturbation
    dict(n_lm=2, seed=5),                           # under-constrained
]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kw", PNP_CASES)
def test_solve_pnp_matches_jax(kw, dtype):
    T_init, T_C_B, p_W, obs, mask, _ = pnp_problem(**kw)
    obs = _noisy(obs, mask, 1)
    obs[0, :3] += 0.05                              # a few gross outliers
    rt, rj = _run(dtype, jpnp.solve_pnp, tpnp.solve_pnp,
                  [T_init, T_C_B, p_W, obs, mask], jpnp.PnPConfig(),
                  tpnp.PnPConfig())
    _check(rt, rj, dtype)
    assert bool(rt.success) == (kw.get("n_lm", 40) >= 6)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_solve_pnp_chi2_and_prior_match_jax(dtype):
    T_init, T_C_B, p_W, obs, mask, T_gt = pnp_problem(seed=9)
    obs = _noisy(obs, mask, 2)
    obs[1, :6] += 0.2
    kw = dict(chi2_gate=0.02, motion_prior_weight=0.5)
    rt, rj = _run(dtype, jpnp.solve_pnp, tpnp.solve_pnp,
                  [T_init, T_C_B, p_W, obs, mask], jpnp.PnPConfig(**kw),
                  tpnp.PnPConfig(**kw), T_W_B_prior=T_gt)
    _check(rt, rj, dtype)


BA_CASES = [
    dict(),                                          # full SE(3) noise
    dict(seed=4, rot_noise=0.0),                     # translation noise only
    dict(seed=2, n_lm=3),                            # under-constrained: skip
]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kw", BA_CASES)
def test_solve_ba_matches_jax(kw, dtype):
    T_init, T_C_B, lms, obs, mask, lm_valid, _, _ = ba_problem(**kw)
    obs = _noisy(obs, mask, 3)
    mask[:, 1, :2] = False                            # mono-only landmarks
    lm_valid[-1] = False                              # an invalid slot
    rt, rj = _run(dtype, jba.solve_ba, tba.solve_ba,
                  [T_init, T_C_B, lms, obs, mask, lm_valid], jba.BAConfig(),
                  tba.BAConfig())
    _check(rt, rj, dtype)
    lj = rj.landmarks
    np.testing.assert_allclose(rt.landmarks.numpy(), lj, rtol=1e-3,
                               atol=1e-3 * np.abs(lj).max())
    np.testing.assert_allclose(float(rt.initial_cost), float(rj.initial_cost),
                               rtol=1e-4)
    if kw.get("n_lm") == 3:
        assert int(rt.status) == int(rj.status) == tba.STATUS_SKIPPED


BA_OPTIONS = [
    pytest.param(dict(chi2_gate=0.05, chi2_gate_iter=1), id="chi2_gate"),
    pytest.param(dict(translation_only=True), id="translation_only"),
    pytest.param(dict(min_lm_span=3), id="min_lm_span"),
]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("cfg", BA_OPTIONS)
def test_solve_ba_options_match_jax(cfg, dtype):
    T_init, T_C_B, lms, obs, mask, lm_valid, _, _ = ba_problem(seed=7)
    obs = _noisy(obs, mask, 4)
    bad = np.random.default_rng(5).uniform(size=mask.shape) < 0.1
    obs[bad] += 0.3                                   # gross outliers
    mask[:2, :, :5] = False                           # short-span landmarks
    rt, rj = _run(dtype, jba.solve_ba, tba.solve_ba,
                  [T_init, T_C_B, lms, obs, mask, lm_valid],
                  jba.BAConfig(**cfg), tba.BAConfig(**cfg))
    _check(rt, rj, dtype)


def _check_f64(rt, rj):
    assert bool(rt.success) == bool(rj.success)
    assert int(rt.iterations) == int(rj.iterations)
    assert int(rt.status) == int(rj.status)
    np.testing.assert_allclose(rt.T_W_B.numpy(), rj.T_W_B, atol=1e-9, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("prior_scale", [None, 0.3])
def test_solve_pnp_weights_and_prior_scale_match_jax(dtype, prior_scale):
    T_init, T_C_B, p_W, obs, mask, T_gt = pnp_problem()
    obs = _noisy(obs, mask, 5)
    obs[0, :3] += 0.05                              # a few gross outliers
    w = np.random.default_rng(6).uniform(0.05, 1.0, p_W.shape[0])
    kw = dict(obs_weight=w.astype(np.float32))
    if prior_scale is not None:
        kw.update(T_W_B_prior=T_gt.astype(np.float32),
                  prior_scale=np.asarray(prior_scale, np.float32))
    cfg_j = jpnp.PnPConfig(motion_prior_weight=20.0, chi2_gate=0.05)
    cfg_t = tpnp.PnPConfig(motion_prior_weight=20.0, chi2_gate=0.05)
    rt, rj = _run(dtype, jpnp.solve_pnp, tpnp.solve_pnp,
                  [T_init, T_C_B, p_W, obs, mask], cfg_j, cfg_t, **kw)
    if dtype == "f64":
        _check_f64(rt, rj)
    else:
        assert bool(rt.success) == bool(rj.success)
        np.testing.assert_allclose(rt.T_W_B.numpy(), rj.T_W_B, atol=1e-4)
    assert bool(rt.success)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_solve_ba_weights_match_jax(dtype):
    T_init, T_C_B, lms, obs, mask, lm_valid, _, _ = ba_problem()
    obs = _noisy(obs, mask, 7)
    w = np.random.default_rng(8).uniform(0.05, 1.0, mask.shape[::2])
    cfg_j, cfg_t = jba.BAConfig(chi2_gate=0.05), tba.BAConfig(chi2_gate=0.05)
    rt, rj = _run(dtype, jba.solve_ba, tba.solve_ba,
                  [T_init, T_C_B, lms, obs, mask, lm_valid], cfg_j, cfg_t,
                  obs_weight=w.astype(np.float32))
    if dtype == "f64":
        _check_f64(rt, rj)
        np.testing.assert_allclose(rt.landmarks.numpy(), rj.landmarks,
                                   atol=1e-9, rtol=0)
    else:
        assert bool(rt.success) == bool(rj.success)
        np.testing.assert_allclose(rt.T_W_B.numpy(), rj.T_W_B, atol=1e-4)
    assert bool(rt.success)


def test_schur_indefinite_system_rejects_step_without_raising():
    """A reduced camera system that is not positive definite gives NaNs
    and ok=False on both sides (torch.linalg.cholesky would raise)."""
    T_init, T_C_B, lms, obs, mask, lm_valid, _, _ = ba_problem(seed=1, w=3)
    lin = jba._linearize_all(jax.vmap(jlie.se3_inverse)(jnp.asarray(T_init)),
                             jnp.asarray(T_C_B), jnp.asarray(lms),
                             jnp.asarray(obs), jnp.asarray(mask), 2.0)
    H_pp, H_ll, H_pl, g_p, g_l = (np.array(x) for x in
                                  jba.build_normal_equations(lin))
    H_pp = -10.0 * H_pp - 5.0 * np.eye(6, dtype=np.float32)  # indefinite S
    act = np.asarray(jba.stereo_observability_mask(jnp.asarray(mask),
                                                   jnp.asarray(lm_valid)))
    args = (H_pp, H_ll, H_pl, g_p, g_l)
    _, _, ok_j = jba.schur_solve(*(jnp.asarray(x) for x in args),
                                 jnp.asarray(1e-4, jnp.float32),
                                 jnp.asarray(act))
    dp, _, ok_t = tba.schur_solve(*(tt(x) for x in args),
                                  torch.tensor(1e-4), tt(act))
    assert not bool(ok_j) and not bool(ok_t)
    assert not torch.isfinite(dp).all()
    # The well-posed system of the same problem solves on both sides.
    H_pp = np.array(jba.build_normal_equations(lin)[0])
    args = (H_pp, H_ll, H_pl, g_p, g_l)
    dj, _, ok_j = jba.schur_solve(*(jnp.asarray(x) for x in args),
                                  jnp.asarray(1e-4, jnp.float32),
                                  jnp.asarray(act))
    dt_, _, ok_t = tba.schur_solve(*(tt(x) for x in args),
                                   torch.tensor(1e-4), tt(act))
    assert bool(ok_j) and bool(ok_t)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-3,
                               atol=1e-5)


def test_singular_pnp_system_gives_nonfinite_not_exception():
    A = torch.zeros(6, 6)
    x = tpnp.solve_or_nan(A, torch.ones(6))
    assert not torch.isfinite(x).any()
    xj = jnp.linalg.solve(jnp.zeros((6, 6)), jnp.ones(6))
    assert not np.isfinite(np.asarray(xj)).all()


BIRTH_CASES = [
    # (alive pattern, cand_ok pattern)
    ("full", "mixed"),                 # full table: nothing lands
    ("last_free", "last_rejected"),    # rejected candidates after the birth
    ("random", "random"),
    ("empty", "all"),                  # more candidates than slots? no: C<N
]


def _birth_inputs(kind_a, kind_c, N=16, C=10, seed=0):
    rng = np.random.default_rng(seed)
    alive = {"full": np.ones(N, bool), "empty": np.zeros(N, bool),
             "random": rng.uniform(size=N) < 0.6,
             "last_free": np.r_[np.ones(N - 1, bool), False]}[kind_a]
    cand = {"mixed": rng.uniform(size=C) < 0.5, "all": np.ones(C, bool),
            "random": rng.uniform(size=C) < 0.5,
            "last_rejected": np.r_[True, np.zeros(C - 1, bool)]}[kind_c]
    return alive, cand


@pytest.mark.parametrize("kind_a,kind_c", BIRTH_CASES)
def test_birth_slots_and_scatter_match_jax(kind_a, kind_c):
    alive, cand = _birth_inputs(kind_a, kind_c)
    sj, okj, rj = jfe.birth_slots(jnp.asarray(alive), jnp.asarray(cand))
    st, okt, rt = tfe.birth_slots(tt(alive), tt(cand))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    arr = np.arange(16 * 2, dtype=np.float32).reshape(16, 2)
    upd = -np.arange(10 * 2, dtype=np.float32).reshape(10, 2) - 1
    out_j = jfe.masked_row_scatter(jnp.asarray(arr), sj, okj, jnp.asarray(upd))
    out_t = tfe.masked_row_scatter(tt(arr), st, okt, tt(upd))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    if kind_a == "last_free":
        assert out_t[15, 0] == upd[0, 0], "birth into the last slot kept"
    if kind_a == "full":
        assert torch.equal(out_t, tt(arr))


def test_birth_slots_more_candidates_than_slots():
    alive = np.array([True, False, True, False])
    cand = np.ones(7, bool)
    sj, okj, _ = jfe.birth_slots(jnp.asarray(alive), jnp.asarray(cand))
    st, okt, _ = tfe.birth_slots(tt(alive), tt(cand))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
