"""Parity of the option paths the shipped VO configs switch on: the RANSAC
consensus gate, and the whole step with each option set (score weights and
the starvation floor, the adaptive defenses, EUCM cameras). The pieces'
own parity tests are in tests/test_torch_ops.py (EUCM, the starvation form
of grid selection) and tests/test_torch_solvers.py (observation weights and
the prior scale).

Inputs are made with numpy from fixed seeds; the JAX functions run on the CPU
(the step with its Pallas KLT kernel in interpret mode), the port's plain
versions on the CPU.

Tolerances:
  * ``ransac_pnp_gate`` with JAX's own Gumbel draws: inlier mask, ok and
    count equal (float32 and float64).
  * Step sequences on tests/test_torch_estimator.py's 96x128 scene for three
    option sets — score weights with the starvation floor engaged on every
    frame and an age ramp; the adaptive defenses (RANSAC K = 8 with JAX's
    draws injected, motion prior 20 scaled by 1 - health, health-scaled
    window weights, health_recover 0.5); an EUCM rig: that file's
    tolerances (flags and counts equal, pose within 1e-3 m / 1e-3 rad) and
    health within 1e-4. The adaptive set ramps health between 0.9 and 1.1
    so that a full consensus reads 0.5 and every health-driven path
    carries a value other than 1.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import estimator as jest
from rsvio_tpu.models import pnp as jpnp
from rsvio_tpu.ops import cameras as jcam
from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.models import pnp as tpnp
from rsvio_tpu_torch.utils import convert
from test_torch_estimator import (FLAGS, POSE_TOL, _compare_states, _frames,
                                  _jax_cfg, _jax_rig, _np, _pose_err,
                                  _torch_cfg)
from test_torch_ops import tt
from test_torch_solvers import _noisy, pnp_problem

torch.set_num_threads(2)

HEALTH_TOL = 1e-4


# --------------------------------------------------------------------------
# RANSAC gate
# --------------------------------------------------------------------------

def _gate_problem(case, seed=31):
    """A PnP problem for the gate: `occluder` moves 30 % of the landmarks'
    observations by another rigid motion; `few_valid` leaves 3 valid
    observations (fewer than a minimal sample)."""
    T_init, T_C_B, p_W, obs, mask, T_gt = pnp_problem(n_lm=48, seed=seed)
    obs = _noisy(obs, mask, seed, sigma=1e-4)
    rng = np.random.default_rng(seed)
    if case == "occluder":
        mover = np.arange(48) % 10 < 3
        obs[:, mover] += np.array([0.06, -0.03], np.float32)
    if case == "few_valid":
        mask[:] = False
        mask[0, [3, 17]] = True
        mask[1, 30] = True
    age = rng.integers(0, 25, 48).astype(np.int32)
    return T_init, T_C_B, p_W, obs, mask, age


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", ["clean", "occluder", "few_valid", "no_age",
                                  "float_vote"])
def test_ransac_pnp_gate_matches_jax(case, dtype):
    """float_vote: an age floor whose weights are not tenths (0.15 x 10
    is not an integer), so the port sums the vote in floating point as
    JAX does instead of exactly in integers."""
    np_dt = np.float32 if dtype == "f32" else np.float64
    T_init, T_C_B, p_W, obs, mask, age = _gate_problem(case)
    arrays = [a.astype(np_dt) for a in (T_init, T_C_B, p_W, obs)] + [mask]
    K = 16
    kw = dict(ransac_age_floor=0.15) if case == "float_vote" else {}
    cfg_j = jpnp.PnPConfig(ransac_hypotheses=K, **kw)
    cfg_t = tpnp.PnPConfig(ransac_hypotheses=K, **kw)
    assert (tpnp.integral_vote_floor(cfg_t) is None) == bool(kw)
    age_j = None if case == "no_age" else jnp.asarray(age)
    with jax.enable_x64(dtype == "f64"):
        key = jax.random.PRNGKey(7)
        gumbel = np.asarray(jax.random.gumbel(key, (K, 2 * p_W.shape[0]),
                                              dtype=np_dt))
        inl_j, ok_j, n_j = (np.asarray(a) for a in jpnp.ransac_pnp_gate(
            *(jnp.asarray(a) for a in arrays), key, cfg_j, age=age_j))
    inl_t, ok_t, n_t = tpnp.ransac_pnp_gate(
        *(tt(a) for a in arrays), tt(gumbel), cfg_t,
        age=None if case == "no_age" else tt(age))
    np.testing.assert_array_equal(inl_t.numpy(), inl_j)
    assert bool(ok_t) == bool(ok_j)
    assert int(n_t) == int(n_j) and n_t.dtype == torch.int32
    want_ok = {"clean": True, "occluder": True, "few_valid": False,
               "no_age": True, "float_vote": True}[case]
    assert bool(ok_t) == want_ok
    if case == "occluder":
        mover = np.arange(48) % 10 < 3
        assert not inl_t.numpy()[:, mover].any()
        assert inl_t.numpy()[:, ~mover].sum() >= 0.9 * mask[:, ~mover].sum()


# The port's gate inputs at frame 19 of occlusion_6dof x vo_adapt (320x204,
# float64, JAX's draws): made by tools/compare_vo_trajectories.py --matrix
# --width 320 --frames 20 --precision f64 --scenes occlusion_6dof --configs
# vo_adapt --dump-gate 19 tests/data/c4_gate_frame19.npz (ROADMAP C4).
C4_GATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "c4_gate_frame19.npz")


def c4_gate_inputs():
    """(T_W_B_init, T_C_B, landmarks, obs, mask, gumbel) as numpy, the ages
    and the port's PnPConfig of the C4 frame."""
    d = np.load(C4_GATE)
    arrays = [d[k] for k in ("T_W_B_init", "T_C_B", "landmarks", "obs",
                             "mask", "gumbel")]
    cfg = tpnp.PnPConfig(**{f: type(v)(d[f]) for f, v in
                            tpnp.PnPConfig()._asdict().items()})
    return arrays, d["age"], cfg


def exact_votes(inliers, age, cfg):
    """Each hypothesis' vote in integers: clip(age, floor * cap, cap)."""
    w = np.clip(age.astype(np.int64),
                int(round(cfg.ransac_age_floor * cfg.ransac_age_cap)),
                cfg.ransac_age_cap)
    return (inliers.astype(np.int64) * w[None, None, :]).sum(axis=(1, 2))


def test_ransac_exact_vote_tie_goes_to_lowest_index():
    """C4 (ROADMAP): on the frame-19 inputs two hypotheses' age-weighted
    votes tie exactly. The port's integer vote gives the tie to the lower
    index; JAX's float64 sum of the same weights rounds the two votes
    apart and takes the other one (its 413 inliers against 409)."""
    arrays, age, cfg = c4_gate_inputs()
    args = [torch.from_numpy(a) for a in arrays]
    inl = tpnp.ransac_hypotheses(*args, cfg,
                                 age=torch.from_numpy(age))[0].numpy()
    votes = exact_votes(inl, age, cfg)
    top = np.flatnonzero(votes == votes.max())
    assert len(top) >= 2 and votes.max() == 3586        # 358.6 in tenths
    inl_t, ok_t, n_t = tpnp.ransac_pnp_gate(*args, cfg,
                                            age=torch.from_numpy(age))
    assert bool(ok_t)
    np.testing.assert_array_equal(inl_t.numpy(), inl[top[0]])
    assert int(n_t) == int(inl[top[0]].sum()) == 409
    with jax.enable_x64(True):
        key = jax.random.fold_in(jax.random.PRNGKey(0x5A11AC), 19)
        np.testing.assert_array_equal(np.asarray(jax.random.gumbel(
            key, arrays[5].shape, dtype=jnp.float64)), arrays[5])
        inl_j, _, n_j = jpnp.ransac_pnp_gate(
            *(jnp.asarray(a) for a in arrays[:5]), key,
            jpnp.PnPConfig(**cfg._asdict()), age=jnp.asarray(age))
        inl_j = np.asarray(inl_j)
    assert int(n_j) == 413
    picks = [k for k in top if np.array_equal(inl[k], inl_j)]
    assert picks and picks[0] > top[0]


# --------------------------------------------------------------------------
# The step with each option set
# --------------------------------------------------------------------------

K_HYP = 8
N_CAP = 32


def _option_sets():
    """name -> (JAX config, port config, camera model)."""
    j0, t0 = _jax_cfg(), _torch_cfg()

    def both(**kw):
        fe = kw.pop("frontend", {})
        pnp = kw.pop("pnp", {})
        out = []
        for c in (j0, t0):
            out.append(c._replace(frontend=c.frontend._replace(**fe),
                                  pnp=c.pnp._replace(**pnp), **kw))
        return out

    return {
        # relax_floor_below above the capacity: starving on every frame;
        # score_weight_ref 60 gives births weights below 1 on this texture.
        "weights": (*both(use_obs_weights=True, obs_weight_age_ramp=0.1,
                          frontend=dict(relax_floor_below=N_CAP + 1,
                                        score_weight_ref=60.0)),
                    "pinhole-radtan"),
        "adaptive": (*both(use_obs_weights=True, pnp_prior_adaptive=True,
                           vision_weight_adaptive=True, health_recover=0.5,
                           health_f_lo=0.9, health_f_hi=1.1,
                           pnp=dict(ransac_hypotheses=K_HYP,
                                    motion_prior_weight=20.0)),
                     "pinhole-radtan"),
        "eucm": (*both(cam_kind_l="eucm", cam_kind_r="eucm"), "eucm"),
    }


def _rig_j(kind):
    if kind == "eucm":
        p = jcam.pack_params(jcam.EUCM, [100.0, 100.0, 64.0, 48.0],
                             [0.5, 1.1])
        return jest.make_rig(p, p, jnp.eye(4, dtype=jnp.float32),
                             jnp.eye(4, dtype=jnp.float32).at[0, 3].set(0.11))
    return _jax_rig()


def _jax_draws(n):
    """The Gumbel draws JAX's step makes for frames 0..n-1."""
    base = jax.random.PRNGKey(0x5A11AC)
    return [np.array(jax.random.gumbel(jax.random.fold_in(base, k),
                                         (K_HYP, 2 * N_CAP),
                                         dtype=jnp.float32))
            for k in range(n)]


def _run_set(name):
    cfg_j, cfg_t, kind = _option_sets()[name]
    frames = _frames()
    step_j = jest.make_estimator_step(cfg_j)
    rig_j = _rig_j(kind)
    state = jest.init_state(cfg_j)
    j_states, j_outs = [_np(state)], []
    for a, b in frames:
        state, out = step_j(state, rig_j, jnp.asarray(a), jnp.asarray(b))
        j_states.append(_np(state))
        j_outs.append(_np(out))
    draws = _jax_draws(len(frames))
    step_t = test_.make_estimator_step(
        cfg_t, draws=lambda fid, shape, dtype, device:
        torch.from_numpy(draws[fid]).to(dtype=dtype, device=device))
    rig_t = convert.rig_from_numpy(_np(rig_j), device="cpu")
    st = test_.init_state(cfg_t, device="cpu")
    t_states, t_outs = [st], []
    for a, b in frames:
        st, out = step_t(st, rig_t, torch.from_numpy(a), torch.from_numpy(b))
        t_states.append(st)
        t_outs.append(out)
    return dict(cfg=cfg_t, rig=rig_t, step=step_t, j_states=j_states,
                j_outs=j_outs, t_states=t_states, t_outs=t_outs)


@pytest.fixture(scope="module")
def run_weights():
    return _run_set("weights")


@pytest.fixture(scope="module")
def run_adaptive():
    return _run_set("adaptive")


@pytest.fixture(scope="module")
def run_eucm():
    return _run_set("eucm")


def _assert_sequence_matches(r):
    saw_ba = False
    for k, (ot, oj) in enumerate(zip(r["t_outs"], r["j_outs"])):
        for f in FLAGS + ("n_ransac_inliers", "n_pnp_candidates"):
            assert int(getattr(ot, f)) == int(getattr(oj, f)), (k, f)
        dt, dr = _pose_err(ot.T_W_B.numpy(), oj.T_W_B)
        assert dt <= POSE_TOL and dr <= POSE_TOL, (k, dt, dr)
        assert abs(float(ot.health) - float(oj.health)) <= HEALTH_TOL, k
        saw_ba = saw_ba or bool(ot.ba_success)
    assert saw_ba and int(ot.n_tracked) >= 10
    assert float(ot.T_W_B[0, 3]) > 0.05, "the rig must have moved"


def _evidence(r, option):
    """The option took effect in the port's run."""
    cfg, outs, states = r["cfg"], r["t_outs"], r["t_states"][1:]
    if option == "use_obs_weights":
        return any(bool((s.table.w[s.table.alive] < 1.0).any())
                   for s in states)
    if option == "age_ramp":
        return any(bool((test_.effective_weights(cfg, s.table)
                         > s.table.w)[s.table.alive].any()) for s in states)
    if option == "starvation_floor":
        # Engaged on every frame, and a cell holds more than one track.
        engaged = all(int(o.n_tracked) < cfg.frontend.relax_floor_below
                      for o in outs)
        s = states[-1]
        cell = (s.table.pos0[:, 1] // cfg.frontend.cell_size * 100
                + s.table.pos0[:, 0] // cfg.frontend.cell_size)[s.table.alive]
        return engaged and len(torch.unique(cell)) < len(cell)
    if option in ("pnp_prior_adaptive", "health_recover"):
        h = [float(o.health) for o in outs]
        return min(h) < 1.0 and states[-1].health_ema is not None
    if option == "vision_weight":
        s = states[-1]
        return bool((s.obs_w[:int(s.kf_count)] < 1.0).any())
    if option == "ransac":
        return (all(int(o.n_ransac_inliers) >= 12 for o in outs[1:])
                and states[-1].lm_birth is not None)
    if option == "eucm":
        return cfg.cam_kind_l == cfg.cam_kind_r == "eucm"
    raise KeyError(option)


PORTED = [
    pytest.param("weights", "use_obs_weights", id="use_obs_weights"),
    pytest.param("weights", "age_ramp", id="age_ramp"),
    pytest.param("weights", "starvation_floor", id="starvation_floor"),
    pytest.param("adaptive", "pnp_prior_adaptive", id="pnp_prior_adaptive"),
    pytest.param("adaptive", "vision_weight", id="vision_weight"),
    pytest.param("adaptive", "health_recover", id="health_recover"),
    pytest.param("adaptive", "ransac", id="ransac"),
    pytest.param("eucm", "eucm", id="eucm"),
]


@pytest.mark.parametrize("set_name,option", PORTED)
def test_ported_option_runs_and_matches_jax(request, set_name, option):
    """Each option that used to raise: its set's 10-frame sequence through
    both steps matches, and the option took effect."""
    r = request.getfixturevalue(f"run_{set_name}")
    _assert_sequence_matches(r)
    assert _evidence(r, option), option


@pytest.mark.parametrize("set_name", ["weights", "adaptive", "eucm"])
def test_one_step_from_converted_state_with_options(request, set_name):
    """The port started from JAX's state before a keyframe with BA
    (converted with its lm_birth, health_ema, table weights and ages, and
    an EUCM rig) steps to JAX's next state."""
    r = request.getfixturevalue(f"run_{set_name}")
    ks = [k for k in range(3, len(r["j_outs"]))
          if bool(r["j_outs"][k].is_keyframe & r["j_outs"][k].ba_success)]
    assert ks
    k = ks[0]
    state = convert.state_from_numpy(r["j_states"][k], device="cpu")
    assert (state.lm_birth is None) == (set_name != "adaptive")
    a, b = _frames()[k]
    new, out = r["step"](state, r["rig"], torch.from_numpy(a),
                         torch.from_numpy(b))
    for f in FLAGS + ("n_ransac_inliers",):
        assert int(getattr(out, f)) == int(getattr(r["j_outs"][k], f)), f
    _compare_states(convert.state_to_numpy(new), r["j_states"][k + 1])


def test_gumbel_draws_are_deterministic_and_device_free():
    a = test_.gumbel_draws(5, (4, 6), torch.float32, "cpu")
    b = test_.gumbel_draws(5, (4, 6), torch.float32, "cpu")
    c = test_.gumbel_draws(6, (4, 6), torch.float32, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = test_.gumbel_draws(0, (200, 500), torch.float64, "cpu")
    # Gumbel(0, 1): mean = Euler-Mascheroni, variance pi^2 / 6.
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03
