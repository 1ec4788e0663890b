"""Parity of the window modules behind the last VO options with the JAX
package: ``state_boxminus``, ``prior_terms`` and ``marginalize_oldest``
(models/marginalization), ``solve_ba_marginalized`` (models/ba),
``refine_landmarks`` (ops/projection), and the estimator's
``reprojection_outliers`` and ``scene_flow_gate``.

The inputs are the cases of tests/test_marginalization.py,
tests/test_ba_marginalized.py, tests/test_projection.py
(TestRefineLandmarks) and tests/test_estimator.py (TestReprojectionOutliers,
TestSceneFlowGate), made here with numpy from the same seeds. Each runs in
float32 and in float64 (``jax.enable_x64`` on the JAX side).

Tolerances:
  * priors (H, g, the gradient and cost of ``prior_terms``): float64
    within 1e-9, float32 within 1e-4, both relative to max|H|.
  * ``solve_ba_marginalized``: as ``solve_ba`` in
    tests/test_torch_solvers.py (float32: equal success, poses within
    1e-4; float64: the same LM path — iterations, status, accept column —
    and poses within 1e-6), and the produced prior as above.
  * ``refine_landmarks``: equal ok; points within 1e-9 (float64) or 1e-4
    (float32) relative to the largest coordinate.
  * ``reprojection_outliers`` and ``scene_flow_gate``: equal masks and kill
    sets; the gate's accumulated flow within 1e-9 / 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import ba as jba
from rsvio_tpu.models import estimator as jest
from rsvio_tpu.models import frontend as jfe
from rsvio_tpu.models import marginalization as jmg
from rsvio_tpu.ops import cameras as jcam
from rsvio_tpu.ops import lie as jlie
from rsvio_tpu.ops import projection as jproj
from rsvio_tpu_torch.models import ba as tba
from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.models import frontend as tfe
from rsvio_tpu_torch.models import marginalization as tmg
from rsvio_tpu_torch.ops import projection as tproj
from rsvio_tpu_torch.utils import convert
from test_torch_solvers import ba_problem, tt

torch.set_num_threads(2)

DTYPES = {"f32": np.float32, "f64": np.float64}
REL = {"f32": 1e-4, "f64": 1e-9}
B = 6
W = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_rel(t, j, scale, dtype, what):
    np.testing.assert_allclose(np.asarray(t), j, rtol=0,
                               atol=REL[dtype] * max(scale, 1.0),
                               err_msg=what)


def _check_prior(pt, pj, dtype):
    """The port's prior (torch) against JAX's (numpy leaves)."""
    scale = float(np.abs(pj.H).max())
    _close_rel(pt.H.numpy(), pj.H, scale, dtype, "H")
    _close_rel(pt.g.numpy(), pj.g, scale, dtype, "g")
    np.testing.assert_allclose(pt.T0.numpy(), pj.T0, rtol=0,
                               atol=REL[dtype])
    assert pt.x0_extra.shape == pj.x0_extra.shape
    assert bool(pt.valid) == bool(pj.valid)


# --------------------------------------------------------------------------
# marginalization: the four cases of tests/test_marginalization.py
# --------------------------------------------------------------------------

def random_psd(n, rng, scale=1.0):
    A = rng.normal(size=(n, n)) * scale
    return A @ A.T + np.eye(n) * 0.1


def _random_poses(rng):
    Ts = []
    for _ in range(W):
        R = jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.2, jnp.float32))
        Ts.append(np.asarray(jlie.se3_from_rt(
            R, jnp.asarray(rng.normal(size=3), jnp.float32))))
    return np.stack(Ts)


def _marg_case(case, dtype):
    """(H, g, T) of a test_marginalization case, in `dtype`."""
    seed = {"dense_schur": 0, "zero_at_lin_point": 1,
            "gradient_moves": 2, "empty_prior": 0}[case]
    rng = np.random.default_rng(seed)
    H = random_psd(W * B, rng)
    g = np.zeros(W * B) if case == "gradient_moves" else rng.normal(size=W * B)
    if case == "zero_at_lin_point":
        T = _random_poses(rng)
    else:
        T = np.broadcast_to(np.eye(4), (W, 4, 4)).copy()
    return H.astype(dtype), g.astype(dtype), T.astype(dtype)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", ["dense_schur", "zero_at_lin_point",
                                  "gradient_moves", "empty_prior"])
def test_marginalization_matches_jax(case, dtype):
    dt = DTYPES[dtype]
    H, g, T = _marg_case(case, dt)
    extra = np.zeros((W, 0), dt)
    with jax.enable_x64(dtype == "f64"):
        if case == "empty_prior":
            pj = jmg.empty_prior(W, B, dt)
        else:
            pj = jmg.marginalize_oldest(jnp.asarray(H), jnp.asarray(g),
                                        jnp.asarray(T), jnp.asarray(extra),
                                        jmg.empty_prior(W, B, dt), B)
        # prior_terms at the (rolled) linearization point and at a
        # perturbed state (the first remaining pose moved 0.1 m in x).
        T_pert = np.asarray(pj.T0).copy()
        T_pert[0, 0, 3] += 0.1
        terms_j = [_np(jmg.prior_terms(pj, jnp.asarray(Tq), pj.x0_extra))
                   for Tq in (np.asarray(pj.T0), T_pert)]
        dx_j = np.asarray(jmg.state_boxminus(jnp.asarray(T_pert),
                                             pj.x0_extra, pj))
        pj = _np(pj)
    if case == "empty_prior":
        pt = tmg.empty_prior(W, B, dtype=torch.from_numpy(H).dtype,
                             device="cpu")
    else:
        pt = tmg.marginalize_oldest(tt(H), tt(g), tt(T), tt(extra),
                                    tmg.empty_prior(W, B, device="cpu"), B)
    _check_prior(pt, pj, dtype)
    assert pt.H.dtype == torch.from_numpy(H).dtype
    scale = max(float(np.abs(pj.H).max()), 1.0)
    for Tq, (Hj, gj, cj) in zip((pt.T0, tt(T_pert)), terms_j):
        Ht, gt, ct = tmg.prior_terms(pt, Tq, pt.x0_extra)
        _close_rel(Ht.numpy(), Hj, scale, dtype, "H_add")
        _close_rel(gt.numpy(), gj, scale, dtype, "g_add")
        _close_rel(float(ct), float(cj), scale, dtype, "cost")
    dx_t = tmg.state_boxminus(tt(T_pert), pt.x0_extra, pt)
    np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=0,
                               atol=REL[dtype])
    # The JAX tests' own assertions, on the port's prior.
    n_r = (W - 1) * B
    if case == "dense_schur":
        Hd = H.astype(np.float64)
        Hmr = Hd[:B, B:]
        Hp_ref = Hd[B:, B:] - Hmr.T @ np.linalg.solve(
            Hd[:B, :B] + 1e-8 * np.eye(B), Hmr)
        np.testing.assert_allclose(pt.H.numpy()[:n_r, :n_r], Hp_ref,
                                   rtol=1e-3, atol=1e-3)
        assert np.abs(pt.H.numpy()[n_r:, :]).max() == 0.0
    if case == "empty_prior":
        assert not bool(pt.valid)
        Ht, gt, ct = tmg.prior_terms(pt, pt.T0, pt.x0_extra)
        assert float(Ht.abs().max()) == float(gt.abs().max()) == 0.0
    else:
        assert bool(pt.valid)


def test_marginalize_oldest_non_pd_block_gives_nan_not_exception():
    """A marginalized block that is not positive definite: NaN, as
    jax.scipy.linalg.cho_factor gives, and no exception."""
    H = np.eye(W * B)
    H[:B, :B] = -np.eye(B)
    pt = tmg.marginalize_oldest(tt(H), tt(np.zeros(W * B)),
                                tt(np.broadcast_to(np.eye(4), (W, 4, 4))),
                                tt(np.zeros((W, 0))),
                                tmg.empty_prior(W, B, device="cpu"), B)
    with jax.enable_x64(True):
        pj = jmg.marginalize_oldest(
            jnp.asarray(H), jnp.zeros(W * B), jnp.broadcast_to(
                jnp.eye(4), (W, 4, 4)), jnp.zeros((W, 0)),
            jmg.empty_prior(W, B, jnp.float64), B)
    n_r = (W - 1) * B
    assert np.isnan(np.asarray(pj.H)[:n_r, :n_r]).all()
    assert torch.isnan(pt.H[:n_r, :n_r]).all()
    assert float(pt.H[n_r:].abs().max()) == 0.0


# --------------------------------------------------------------------------
# solve_ba_marginalized: the five cases of tests/test_ba_marginalized.py
# --------------------------------------------------------------------------

W_KF = 5


def _roll(a):
    return np.concatenate([a[1:], a[-1:]], axis=0)


def _solve_both(dtype, arrays, prior_j, prior_t, will_evict):
    dt = DTYPES[dtype]
    arrays = [a.astype(dt) if a.dtype.kind == "f" else a for a in arrays]
    with jax.enable_x64(dtype == "f64"):
        rj, pj = jba.solve_ba_marginalized(
            *(jnp.asarray(a) for a in arrays),
            jmg.MargPrior(*(jnp.asarray(a) for a in prior_j)),
            jnp.asarray(will_evict), jba.BAConfig())
        rj, pj = _np(rj), _np(pj)
    rt, pt = tba.solve_ba_marginalized(
        *(tt(a) for a in arrays), prior_t, torch.tensor(will_evict),
        tba.BAConfig())
    assert bool(rt.success) == bool(rj.success)
    tol = 1e-4 if dtype == "f32" else 1e-6
    np.testing.assert_allclose(rt.T_W_B.numpy(), rj.T_W_B, atol=tol, rtol=0)
    if dtype == "f64":
        assert int(rt.iterations) == int(rj.iterations)
        assert int(rt.status) == int(rj.status)
        np.testing.assert_array_equal(rt.metrics.numpy()[:, 5],
                                      rj.metrics[:, 5])
        np.testing.assert_allclose(rt.metrics.numpy()[:, :4],
                                   rj.metrics[:, :4], rtol=1e-6, atol=1e-12)
    _check_prior(pt, pj, dtype)
    return rt, pt, rj, pj


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", [
    "no_evict_passes_prior_through", "prior_produced_on_evict",
    "prior_anchors_gauge_after_roll", "skipped_solve_keeps_prior",
    "metrics_recorded"])
def test_solve_ba_marginalized_matches_jax(case, dtype):
    seed = {"no_evict_passes_prior_through": 21,
            "prior_produced_on_evict": 22,
            "prior_anchors_gauge_after_roll": 23,
            "skipped_solve_keeps_prior": 24, "metrics_recorded": 5}[case]
    kw = (dict(pose_noise=0.01, lm_noise=0.02, rot_noise=0.005)
          if case == "prior_anchors_gauge_after_roll" else {})
    T_init, T_C_B, lms, obs, mask, lm_valid, _, _ = ba_problem(
        seed=seed, **kw)
    if case == "skipped_solve_keeps_prior":
        obs, mask = np.zeros_like(obs), np.zeros_like(mask)
    dt = DTYPES[dtype]
    prior_t = tmg.empty_prior(W_KF, 6, dtype=torch.from_numpy(
        np.zeros(1, dt)).dtype, device="cpu")
    prior_j = tmg.MargPrior(*(a.numpy() for a in prior_t))
    evict = case != "no_evict_passes_prior_through"
    arrays = [T_init, T_C_B, lms, obs, mask, lm_valid]
    rt, pt, rj, pj = _solve_both(dtype, arrays, prior_j, prior_t, evict)
    if case == "no_evict_passes_prior_through":
        assert bool(rt.success) and not bool(pt.valid)
        assert float(pt.H.abs().max()) == 0.0
    elif case == "skipped_solve_keeps_prior":
        assert not bool(rt.success) and not bool(pt.valid)
        assert int(rt.status) == tba.STATUS_SKIPPED
    else:
        assert bool(rt.success) and bool(pt.valid)
        n_r = (W_KF - 1) * 6
        assert float(pt.H[:n_r, :n_r].abs().max()) > 1e-3
        assert float(pt.H[n_r:].abs().max()) == 0.0
    if case == "metrics_recorded":
        it = int(rt.iterations)
        m = rt.metrics.numpy()
        assert it >= 1 and np.any(m[:it, 0] > 0) and np.all(m[it:] == 0)
    if case == "prior_anchors_gauge_after_roll":
        # Roll the window (drop KF0, duplicate the newest) and re-solve
        # anchored by each side's own prior: no pose is hard-fixed.
        arrays2 = [_roll(rt.T_W_B.numpy()), T_C_B.astype(dt),
                   rt.landmarks.numpy(), _roll(obs).astype(dt), _roll(mask),
                   lm_valid]
        with jax.enable_x64(dtype == "f64"):
            rj2, _ = jba.solve_ba_marginalized(
                jnp.asarray(_roll(rj.T_W_B)), jnp.asarray(T_C_B.astype(dt)),
                jnp.asarray(rj.landmarks), jnp.asarray(_roll(obs).astype(dt)),
                jnp.asarray(_roll(mask)), jnp.asarray(lm_valid),
                jax.tree_util.tree_map(jnp.asarray, pj), jnp.asarray(False),
                jba.BAConfig())
            rj2 = _np(rj2)
        rt2, _ = tba.solve_ba_marginalized(
            *(tt(a) for a in arrays2), pt, torch.tensor(False),
            tba.BAConfig())
        assert bool(rt2.success) == bool(rj2.success) is True
        tol = 1e-4 if dtype == "f32" else 1e-6
        np.testing.assert_allclose(rt2.T_W_B.numpy(), rj2.T_W_B, atol=tol,
                                   rtol=0)
        drift = np.abs(rt2.T_W_B.numpy()[:W_KF - 1, :3, 3]
                       - rt.T_W_B.numpy()[1:, :3, 3]).max()
        assert drift < 0.05


# --------------------------------------------------------------------------
# refine_landmarks: tests/test_projection.py TestRefineLandmarks
# --------------------------------------------------------------------------

def _refine_setup(n_lm=24, w=5, noise=0.08, seed=13):
    rng = np.random.default_rng(seed)
    T_C_B = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    T_C_B[1, 0, 3] = -0.11
    T_B_W = []
    for i in range(w):
        R = jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.03, jnp.float32))
        T_B_W.append(np.asarray(jlie.se3_inverse(jlie.se3_from_rt(
            R, jnp.asarray([0.25 * i, 0.02 * i, 0.0], jnp.float32)))))
    T_B_W = np.stack(T_B_W)
    p_gt = np.stack([rng.uniform(-2, 3, n_lm), rng.uniform(-2, 2, n_lm),
                     rng.uniform(3, 8, n_lm)], axis=1).astype(np.float32)
    obs = np.zeros((w, 2, n_lm, 2), np.float32)
    mask = np.zeros((w, 2, n_lm), bool)
    for i in range(w):
        for c in range(2):
            pC = (T_C_B[c, :3, :3] @ (T_B_W[i, :3, :3] @ p_gt.T
                                      + T_B_W[i, :3, 3:4])
                  + T_C_B[c, :3, 3:4]).T
            ok = pC[:, 2] > 0.5
            obs[i, c, ok] = pC[ok, :2] / pC[ok, 2:3]
            mask[i, c] = ok
    p_init = p_gt + rng.normal(size=p_gt.shape).astype(np.float32) * noise
    return T_C_B, T_B_W, p_init, obs, mask, p_gt


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", ["recovers_noisy_init",
                                  "underobserved_unchanged"])
def test_refine_landmarks_matches_jax(case, dtype):
    dt = DTYPES[dtype]
    T_C_B, T_B_W, p_init, obs, mask, p_gt = _refine_setup()
    if case == "underobserved_unchanged":
        mask[:, :, 0] = False               # no observation
        mask[1:, :, 1] = False
        mask[0, 1, 1] = False               # one observation left
    arrays = [a.astype(dt) for a in (T_C_B, T_B_W, p_init, obs)] + [mask]
    with jax.enable_x64(dtype == "f64"):
        pj, okj = _np(jproj.refine_landmarks(*(jnp.asarray(a)
                                               for a in arrays)))
    pt, okt = tproj.refine_landmarks(*(tt(a) for a in arrays))
    np.testing.assert_array_equal(okt.numpy(), okj)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0,
                               atol=REL[dtype] * np.abs(pj).max())
    if case == "recovers_noisy_init":
        assert okt.all() and np.abs(pt.numpy() - p_gt).max() < 1e-3
    else:
        assert not okt[0] and not okt[1]
        np.testing.assert_array_equal(pt.numpy()[:2], arrays[2][:2])


# --------------------------------------------------------------------------
# reprojection_outliers: tests/test_estimator.py TestReprojectionOutliers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", ["corrupt_landmark", "behind_camera"])
def test_reprojection_outliers_matches_jax(case, dtype):
    dt = DTYPES[dtype]
    if case == "corrupt_landmark":
        rng = np.random.default_rng(0)
        Wk, N = 3, 12
        lm = np.stack([rng.uniform(-1, 1, N), rng.uniform(-1, 1, N),
                       rng.uniform(3, 6, N)], 1)
        T_C_B = np.stack([np.eye(4), np.eye(4)])
        T_C_B[1, 0, 3] = -0.1
        obs = np.zeros((Wk, 2, N, 2))
        for c in range(2):
            pC = lm + T_C_B[c, :3, 3]
            obs[:, c] = pC[:, :2] / pC[:, 2:3]
        lm[4] += [1.0, 0.0, 0.0]
        thr, want = 0.01 ** 2, np.arange(N) == 4
    else:
        Wk, N = 2, 3
        lm = np.array([[0, 0, 5.0], [0, 0, -2.0], [0.5, 0, 4.0]])
        T_C_B = np.stack([np.eye(4)] * 2)
        obs = np.stack([lm[:, :2] / lm[:, 2:3]] * 2)[None].repeat(Wk, 0)
        thr, want = 1e6, np.arange(N) == 1
    kf_T = np.broadcast_to(np.eye(4), (Wk, 4, 4))
    mask = np.ones((Wk, 2, N), bool)
    mask[0, 1, 7 % N] = False             # a masked-out observation
    arrays = [a.astype(dt) for a in (T_C_B, kf_T, lm, obs)] + [
        mask, np.ones(N, bool)]
    with jax.enable_x64(dtype == "f64"):
        bj = np.asarray(jest.reprojection_outliers(
            *(jnp.asarray(a) for a in arrays), thr))
    bt = test_.reprojection_outliers(*(tt(a) for a in arrays), thr)
    np.testing.assert_array_equal(bt.numpy(), bj)
    np.testing.assert_array_equal(bt.numpy(), want)


# --------------------------------------------------------------------------
# scene_flow_gate: tests/test_estimator.py TestSceneFlowGate
# --------------------------------------------------------------------------

N_FLOW = 32


def _flow_setup(dt):
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(-1, 1, N_FLOW), rng.uniform(-0.6, 0.6, N_FLOW),
                    rng.uniform(2.0, 6.0, N_FLOW)], axis=1).astype(dt)
    params = np.asarray(jcam.pack_params(jcam.PINHOLE_RADTAN,
                                         [120.0, 120.0, 80.0, 60.0],
                                         [0, 0, 0, 0])).astype(dt)
    T_r = np.eye(4, dtype=dt)
    T_r[0, 3] = 0.11
    with jax.enable_x64(dt == np.float64):
        rig_j = jest.make_rig(jnp.asarray(params), jnp.asarray(params),
                              jnp.eye(4, dtype=dt), jnp.asarray(T_r))
        rig_np = _np(rig_j)
    table_np = _np(jfe.init_table(N_FLOW))._replace(
        alive=np.ones(N_FLOW, bool), fid=np.arange(N_FLOW, dtype=np.int32))
    return rig_j, rig_np, table_np, pts


def _flow_frames(case, pts, dt):
    """Per keyframe (obs (2,N,2), tri_all (N,3)) as in the JAX tests: movers
    displace laterally by 0.03 z a keyframe; "noise" is the static world
    with ~0.5 px of noise over 6 keyframes; "even_count" is the mover case
    with that noise on every point."""
    mover = np.zeros(N_FLOW, bool)
    mover[:{"mover": 8, "uncentered": 6, "even_count": 8}.get(case, 0)] = True
    frames = []
    pts_k = pts.astype(np.float64).copy()
    rng = np.random.default_rng(11)
    for k in range(6 if case == "noise" else 4):
        pts_k[mover, 0] += 0.03 * pts_k[mover, 2]
        cur = pts_k
        if case in ("noise", "even_count"):
            cur = pts_k + rng.normal(0, 0.004, pts.shape)
        obs = np.stack([cur[:, :2] / cur[:, 2:3],
                        (cur[:, :2] - np.array([0.11, 0.0])[None])
                        / cur[:, 2:3]])
        frames.append((obs.astype(dt), cur.astype(dt)))
    return frames, mover


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", ["mover", "uncentered", "noise",
                                  "even_count"])
def test_scene_flow_gate_matches_jax(case, dtype):
    """Keyframe after keyframe through both gates from the same memory:
    equal kill sets and counts, accumulated flow within tolerance. In the
    even_count case two tracks have no stereo triangulation, so 30 flows
    are valid and the centring median must average the two middle values
    as jnp.nanmedian does; torch.nanmedian takes the lower one, which
    moves the accumulated flow by more than the tolerance."""
    dt = DTYPES[dtype]
    rig_j, rig_np, table_np, pts = _flow_setup(dt)
    kw = dict(dynamic_flow_thresh=0.02, dynamic_flow_decay=0.7,
              dynamic_flow_min_n=2,
              dynamic_flow_center=case != "uncentered")
    cfg_j, cfg_t = jest.EstimatorConfig(**kw), test_.EstimatorConfig(**kw)
    rig_t = convert.rig_from_numpy(rig_np, device="cpu")
    table_t = tfe.FeatureTable(*(tt(a) for a in table_np))
    frames, mover = _flow_frames(case, pts, dt)
    tri_ok = np.ones(N_FLOW, bool)
    if case == "even_count":
        tri_ok[-2:] = False
    T_cur = np.eye(4, dtype=dt)
    mem_j = (pts, table_np.fid, np.zeros((N_FLOW, 2), dt),
             np.zeros(N_FLOW, np.int32))
    mem_t = tuple(tt(a) for a in mem_j)
    killed = np.zeros(N_FLOW, bool)
    tol = 1e-5 if dtype == "f32" else 1e-9
    for k, (obs, tri) in enumerate(frames):
        mask = np.ones((2, N_FLOW), bool)
        with jax.enable_x64(dtype == "f64"):
            kj, mj, nj = jest.scene_flow_gate(
                cfg_j, rig_j, jnp.asarray(T_cur), jnp.asarray(obs),
                jnp.asarray(mask), jfe.FeatureTable(
                    *(jnp.asarray(a) for a in table_np)),
                jnp.asarray(tri), jnp.asarray(tri_ok),
                *(jnp.asarray(a) for a in mem_j))
            kj, mj, nj = np.asarray(kj), _np(mj), int(nj)
        kt, mt, nt = test_.scene_flow_gate(
            cfg_t, rig_t, tt(T_cur), tt(obs), tt(mask), table_t, tt(tri),
            tt(tri_ok), *mem_t)
        np.testing.assert_array_equal(kt.numpy(), kj, err_msg=str(k))
        assert int(nt) == nj and nt.dtype == torch.int32
        np.testing.assert_array_equal(mt[1].numpy(), mj[1])
        np.testing.assert_array_equal(mt[3].numpy(), mj[3])
        np.testing.assert_allclose(mt[2].numpy(), mj[2], rtol=0, atol=tol)
        if case == "even_count" and k == 0:
            have = tri_ok & (mem_j[1] >= 0)
            assert have.sum() == 30
            flow = np.where(have[:, None], obs[0].astype(np.float64)
                            - mem_j[0][:, :2] / mem_j[0][:, 2:3], np.nan)
            med_np = np.nanmedian(flow, axis=0)
            med_t = test_.nanmedian_columns(tt(flow)).numpy()
            med_lower = torch.nanmedian(tt(flow), dim=0).values.numpy()
            np.testing.assert_allclose(med_t, med_np, rtol=0, atol=1e-12)
            assert np.abs(med_lower - med_np).max() > 2 * tol
        mem_j, mem_t = mj, mt
        killed |= kj
    if case in ("mover", "uncentered", "even_count"):
        assert killed[mover].all() and not killed[~mover].any()
    else:
        assert not killed.any()


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_nanmedian_columns_matches_numpy(dtype):
    """Odd, even, single and empty columns."""
    x = np.array([[1, 4, np.nan, np.nan],
                  [2, np.nan, np.nan, 7],
                  [3, 1, np.nan, np.nan],
                  [4, 2, np.nan, np.nan],
                  [np.nan, 9, np.nan, np.nan]], DTYPES[dtype])
    m = test_.nanmedian_columns(tt(x)).numpy()
    np.testing.assert_array_equal(np.isnan(m), [False, False, True, False])
    np.testing.assert_allclose(m[[0, 1, 3]], [2.5, 3.0, 7.0], rtol=0)
    with jax.enable_x64(dtype == "f64"):
        mj = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=0))
    np.testing.assert_array_equal(m, mj)
