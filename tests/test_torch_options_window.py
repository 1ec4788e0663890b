"""Parity of the step with the window options of the VO estimator:
marginalization of evicted keyframes, birth refinement, post-BA culling,
tracking only once the window is full, the constant-velocity PnP seed and
the stereo scene-flow gate. Their modules' own parity tests are in
tests/test_torch_marginalization.py.

Setup: tests/test_torch_estimator.py's 96x128 rolling-texture scene and
configuration (window 4, 10 frames); the JAX step runs its Pallas KLT kernel
in interpret mode, the port the kernel's plain version, both on the CPU in
float32. Four option sets, each run once per module:

  * ``marg``: use_marginalization. The window fills at frame 3, so every
    keyframe from then on evicts: a prior is made at least twice, and later
    solves are anchored by it instead of by pose 0.
  * ``window``: refine_births, cull_reproj_threshold 3e-4 and
    track_before_full=False. This scene's reprojection errors are ~1e-4
    (normalized), so 3e-4 culls a few landmarks; the JAX package's
    gross-outlier scale (0.02, tests/test_estimator.py) culls none here.
  * ``cv``: pnp_cv_predict.
  * ``flow``: dynamic_flow_thresh 1e-3. The scene is rigid; at this
    threshold the gate still kills a track whose residual flow
    accumulates, so the kill path runs.

Tolerances: tests/test_torch_estimator.py's — per frame, the keyframe / PnP
/ BA flags, the track, landmark, occupancy and n_dyn_killed counts equal,
T_W_B within 1e-3 m and 1e-3 rad; one step from a converted state with a
valid prior: that file's state tolerance, the prior's H and g within 1e-4
relative to max|H|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import estimator as jest
from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.utils import convert
from test_torch_estimator import (FLAGS, POSE_TOL, _compare_states, _frames,
                                  _jax_cfg, _jax_rig, _np, _pose_err,
                                  _torch_cfg)

torch.set_num_threads(2)

SETS = {
    "marg": dict(use_marginalization=True),
    "window": dict(refine_births=True, cull_reproj_threshold=3e-4,
                   track_before_full=False),
    "cv": dict(pnp_cv_predict=True),
    "flow": dict(dynamic_flow_thresh=1e-3),
}


def _run_set(name):
    """Both steps over the sequence from their initial states; the JAX
    states before each frame and after the last (numpy), both outputs, and
    the port's states and probe counts."""
    cfg_j = _jax_cfg()._replace(**SETS[name])
    cfg_t = _torch_cfg()._replace(**SETS[name])
    frames = _frames()
    step_j = jest.make_estimator_step(cfg_j)
    rig_j = _jax_rig()
    state = jest.init_state(cfg_j)
    j_states, j_outs = [_np(state)], []
    for a, b in frames:
        state, out = step_j(state, rig_j, jnp.asarray(a), jnp.asarray(b))
        j_states.append(_np(state))
        j_outs.append(_np(out))
    probe = {}
    step_t = test_.make_estimator_step(cfg_t, probe=probe)
    rig_t = convert.rig_from_numpy(_np(rig_j), device="cpu")
    st = test_.init_state(cfg_t, device="cpu")
    t_states, t_outs = [st], []
    for a, b in frames:
        st, out = step_t(st, rig_t, torch.from_numpy(a), torch.from_numpy(b))
        t_states.append(st)
        t_outs.append(out)
    return dict(cfg=cfg_t, rig=rig_t, step=step_t, j_states=j_states,
                j_outs=j_outs, t_states=t_states, t_outs=t_outs,
                probe={k: int(v) for k, v in probe.items()})


@pytest.fixture(scope="module")
def run_marg():
    return _run_set("marg")


@pytest.fixture(scope="module")
def run_window():
    return _run_set("window")


@pytest.fixture(scope="module")
def run_cv():
    return _run_set("cv")


@pytest.fixture(scope="module")
def run_flow():
    return _run_set("flow")


def _assert_sequence_matches(r):
    for k, (ot, oj) in enumerate(zip(r["t_outs"], r["j_outs"])):
        for f in FLAGS + ("n_dyn_killed",):
            assert int(getattr(ot, f)) == int(getattr(oj, f)), (k, f)
        dt, dr = _pose_err(ot.T_W_B.numpy(), oj.T_W_B)
        assert dt <= POSE_TOL and dr <= POSE_TOL, (k, dt, dr)
    for st, sj in zip(r["t_states"], r["j_states"]):
        assert bool(st.marg_prior.valid) == bool(sj.marg_prior.valid)
    assert any(bool(o.ba_success) for o in r["t_outs"])
    assert int(ot.n_tracked) >= 10
    assert float(ot.T_W_B[0, 3]) > 0.05, "the rig must have moved"


def _evidence(r, option):
    """The option took effect in the port's run."""
    cfg, outs, states, probe = (r["cfg"], r["t_outs"], r["t_states"],
                                r["probe"])
    W = cfg.window_size
    if option == "use_marginalization":
        return probe["priors_made"] >= 2 and bool(states[-1].marg_prior.valid)
    if option == "prior_used":
        # A solve that succeeded with a valid prior coming in (its gauge
        # anchored by the prior, not by pose 0).
        return any(bool(states[k].marg_prior.valid)
                   and bool(outs[k].ba_success) for k in range(len(outs)))
    if option == "refine_births":
        return probe["refined"] > 0
    if option == "cull_reproj":
        return probe["culled"] > 0
    if option == "track_before_full":
        # No PnP before the window is full, and the first solve on the
        # keyframe that fills it.
        fill = [int(s.kf_count) for s in states[:-1]]
        return (not any(bool(o.pnp_success)
                        for o, n in zip(outs, fill) if n < W)
                and not any(bool(o.ba_success)
                            for o, n in zip(outs, fill) if n < W - 1)
                and bool(outs[fill.index(W - 1)].ba_success))
    if option == "pnp_cv_predict":
        return probe["cv_seeded"] > 0
    if option == "dynamic_flow":
        return (sum(int(o.n_dyn_killed) for o in outs) > 0
                and int((states[-1].flow_n > 0).sum()) > 0)
    raise KeyError(option)


PORTED = [
    pytest.param("marg", "use_marginalization", id="use_marginalization"),
    pytest.param("marg", "prior_used", id="marg_prior_used"),
    pytest.param("window", "refine_births", id="refine_births"),
    pytest.param("window", "cull_reproj", id="cull_reproj"),
    pytest.param("window", "track_before_full", id="track_before_full"),
    pytest.param("cv", "pnp_cv_predict", id="pnp_cv_predict"),
    pytest.param("flow", "dynamic_flow", id="dynamic_flow_thresh"),
]


@pytest.mark.parametrize("set_name,option", PORTED)
def test_ported_option_runs_and_matches_jax(request, set_name, option):
    """Each option that used to raise: its set's sequence through both
    steps matches, and the option took effect."""
    r = request.getfixturevalue(f"run_{set_name}")
    _assert_sequence_matches(r)
    assert _evidence(r, option), (option, r["probe"])


@pytest.mark.parametrize("kind", ["marg_prior_valid"])
def test_one_step_from_converted_state(run_marg, kind):
    """The port started from JAX's state before a keyframe whose solve
    uses a valid prior (carried across by utils/convert.py) steps to JAX's
    next state, new prior included."""
    r = run_marg
    ks = [k for k in range(len(r["j_outs"]))
          if bool(r["j_states"][k].marg_prior.valid)
          and bool(r["j_outs"][k].is_keyframe & r["j_outs"][k].ba_success)]
    assert ks
    k = ks[0]
    state = convert.state_from_numpy(r["j_states"][k], device="cpu")
    assert bool(state.marg_prior.valid)
    a, b = _frames()[k]
    new, out = r["step"](state, r["rig"], torch.from_numpy(a),
                         torch.from_numpy(b))
    for f in FLAGS:
        assert int(getattr(out, f)) == int(getattr(r["j_outs"][k], f)), f
    want = r["j_states"][k + 1]
    got = convert.state_to_numpy(new)
    pj, pt = want.marg_prior, got.marg_prior
    scale = float(np.abs(pj.H).max())
    assert bool(pt.valid) and scale > 0.0
    np.testing.assert_allclose(pt.H, pj.H, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(pt.g, pj.g, rtol=0, atol=1e-4 * scale)
    _compare_states(got._replace(marg_prior=pj), want)
