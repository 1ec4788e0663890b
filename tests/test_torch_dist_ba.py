"""The port's landmark-sharded window solvers (rsvio_tpu_torch/parallel/
dist_ba.py, dist_vio_ba.py) at world size 2 over gloo on the CPU, against
the JAX package's distributed solvers on a 2-device CPU mesh.

Setup: tests/test_ba.py's make_problem and tests/test_vio_ba.py's
make_vio_problem, as test_dist_ba.py uses them, made once with JAX and
written to an .npz file; two ranks are spawned ONCE for the file
(torch_dist_ranks.solver_cases, a file store under tmp_path, 120 s
deadline) and run every case; the ranks import neither JAX nor rsvio_tpu.

Tolerances:
  * float32 against JAX's distributed solvers, those of
    tests/test_dist_ba.py: poses and landmarks rtol 1e-3, atol 1e-4; the
    VIO velocity rtol 1e-2, atol 1e-3; the final cost within 1e-4 of
    max(1, cost); the prior's T0 rtol 1e-3 / atol 1e-4 and H / max|H|
    within 5e-3. The chi^2 gate case (not in test_dist_ba.py) at the pose
    and landmark tolerances.
  * float64 against the port's own single-device solvers: the same
    iteration count and status, poses, landmarks, costs, metrics and
    prior within 1e-8 relative (the shards' sums round differently from
    one sum, 1e-16 a step).
  * the two ranks' results bitwise equal (every rank solves the same
    all-reduced system and gathers the same landmarks);
  * the all-reduce bytes of a solve the same at 32 and 64 landmarks.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import ba as jba
from rsvio_tpu.models.imu import Preintegrated as JPreintegrated
from rsvio_tpu.models import vio_ba as jvb
from rsvio_tpu.models.marginalization import empty_prior as j_empty_prior
from rsvio_tpu.parallel import dist_ba as jdist
from rsvio_tpu.parallel import dist_vio_ba as jdist_vio
from rsvio_tpu.parallel import mesh as jmesh
from rsvio_tpu_torch.models import ba as tba
from rsvio_tpu_torch.models import vio_ba as tvb
from rsvio_tpu_torch.parallel import dryrun

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from test_ba import make_problem  # noqa: E402
from test_vio_ba import make_vio_problem  # noqa: E402

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _vo(seed, n_lm=32, outliers=False):
    T, T_C_B, lms, obs, mask, lm_valid, _, _ = _np(make_problem(
        seed=seed, n_lm=n_lm))
    if outliers:
        rng = np.random.default_rng(seed)
        obs = np.where(mask[..., None],
                       obs + rng.normal(size=obs.shape) * 2e-3, obs)
        obs[rng.uniform(size=mask.shape) < 0.1] += 0.3
        obs = obs.astype(np.float32)
    return dict(T_W_B=T, T_C_B=T_C_B, lms=lms, obs=obs, mask=mask,
                lm_valid=lm_valid)


def _vio(seed):
    st, T_C_B, lms, obs, mask, lm_valid, pre, pre_valid, *_ = _np(
        make_vio_problem(seed=seed))
    d = dict(T_W_B=st.T_W_B, vel=st.vel, bg=st.bg, ba=st.ba, T_C_B=T_C_B,
             lms=lms, obs=obs, mask=mask, lm_valid=lm_valid,
             pre_valid=pre_valid)
    d.update({f"pre.{f}": v for f, v in zip(pre._fields, pre)})
    return d


def _noisy(p, seed=3):
    """~1 px of observation noise, so the optimum's cost is far above 0
    and float64 LM decisions do not hang on rounding."""
    rng = np.random.default_rng(seed)
    return dict(p, obs=np.where(p["mask"][..., None], p["obs"] + rng.normal(
        size=p["obs"].shape) * 2e-3, p["obs"]).astype(np.float32))


def _weights(p, seed):
    rng = np.random.default_rng(seed)
    return dict(p, obs_weight=rng.uniform(
        0.3, 1.0, (p["T_W_B"].shape[0], p["lms"].shape[0])).astype(np.float32))


def _skip(p):
    return dict(p, obs=np.zeros_like(p["obs"]), mask=np.zeros_like(p["mask"]))


# Inputs by prefix.
INPUTS = {
    "vo11": lambda: _vo(11),
    "vo11x2": lambda: _vo(11, n_lm=64),
    "vo12w": lambda: _weights(_vo(21), 21),
    "vo7chi2": lambda: _vo(7, outliers=True),
    "vo21": lambda: _vo(21),
    "vo13skip": lambda: _skip(_vo(13)),
    "vo23skip": lambda: _skip(_vo(23)),
    "vo31": lambda: _vo(31, n_lm=31),
    "vio41": lambda: _vio(41),
    "vio71": lambda: _vio(71),
    "vio71w": lambda: _weights(_vio(71), 5),
}
CHI2 = dict(chi2_gate=0.05, chi2_gate_iter=1)
# (name, kind, input, cfg kwargs) run in both float32 and float64.
CASES = [
    ("ba", "ba", "vo11", {}),
    ("ba_x2", "ba", "vo11x2", {}),
    ("ba_w", "ba", "vo12w", {}),
    ("ba_chi2", "ba", "vo7chi2", CHI2),
    ("marg", "ba_marg", "vo21", {}),
    ("marg_chi2w", "ba_marg", "vo7chi2", CHI2),
    ("skip", "ba", "vo13skip", {}),
    ("marg_skip", "ba_marg", "vo23skip", {}),
    ("vio", "vio", "vio41", {}),
    ("vio_chi2", "vio", "vio41", CHI2),
    ("vio_marg", "vio_marg", "vio71", {}),
    ("vio_marg_w", "vio_marg", "vio71w", CHI2),
]
# float64 runs on the inputs with observation noise (suffix "n").
INPUTS.update({k + "n": (lambda f=f: _noisy(f())) for k, f in
               list(INPUTS.items())})
RANK_CASES = ([(f"{n}.f32", k, i, c, "f32") for n, k, i, c in CASES]
              + [(f"{n}.f64", k, i + "n", c, "f64") for n, k, i, c in CASES]
              + [("ba_bad_L", "ba", "vo31", {}, "f32")])
JAX_CASES = ("ba", "ba_w", "ba_chi2", "marg", "vio", "vio_marg")


@pytest.fixture(scope="module")
def inputs():
    return {k: f() for k, f in INPUTS.items()}


@pytest.fixture(scope="module")
def ranked(inputs, tmp_path_factory):
    """Both ranks' results (one spawn for the file)."""
    d = tmp_path_factory.mktemp("dist_ba")
    path = str(d / "inputs.npz")
    np.savez(path, **{f"{pre}.{k}": v for pre, p in inputs.items()
                      for k, v in p.items()})
    return dryrun.run_ranks(ranks.solver_cases, 2, path, RANK_CASES,
                            devices="cpu", timeout=120.0, workdir=str(d),
                            threads=1)


def _get(res, name):
    """{field: array} of one case's flattened result."""
    return {k[len(name) + 1:]: v for k, v in res.items()
            if k.startswith(name + ".")}


@pytest.fixture(scope="module")
def jax_results(inputs):
    """JAX's distributed solvers on a 2-device CPU mesh."""
    mesh = jmesh.make_mesh(2)
    out = {}
    for name, kind, pre, cfg_kw in CASES:
        if name not in JAX_CASES:
            continue
        p = {k: jnp.asarray(v) for k, v in inputs[pre].items()}
        w = p.get("obs_weight")
        vo = (p["T_W_B"], p["T_C_B"], p["lms"], p["obs"], p["mask"],
              p["lm_valid"])
        if kind == "ba":
            r = jdist.solve_ba_distributed(mesh, *vo, jba.BAConfig(**cfg_kw),
                                           obs_weight=w)
        elif kind == "ba_marg":
            r = jdist.solve_ba_marginalized_distributed(
                mesh, *vo, j_empty_prior(vo[0].shape[0], 6),
                jnp.asarray(True), jba.BAConfig(**cfg_kw), obs_weight=w)
        else:
            st = jvb.VIOState(T_W_B=p["T_W_B"], vel=p["vel"], bg=p["bg"],
                              ba=p["ba"])
            pre_ = JPreintegrated(*(p[f"pre.{f}"]
                                    for f in JPreintegrated._fields))
            va = (st, *vo[1:], pre_, p["pre_valid"])
            if kind == "vio":
                r = jdist_vio.solve_vio_ba_distributed(
                    mesh, *va, jvb.VIOBAConfig(**cfg_kw), obs_weight=w)
            else:
                r = jdist_vio.solve_vio_ba_marginalized_distributed(
                    mesh, *va, j_empty_prior(vo[0].shape[0], 15),
                    jnp.asarray(True), jvb.VIOBAConfig(**cfg_kw),
                    obs_weight=w)
        flat = {}
        ranks.flatten(name, _np(r), flat)
        out[name] = _get(flat, name)
    return out


def _single_f64(kind, p, cfg_kw):
    """The port's single-device solver on the float64 inputs."""
    p = {k: torch.tensor(v, dtype=torch.float64 if v.dtype.kind == "f"
                         else None) for k, v in p.items()}
    w = p.get("obs_weight")
    yes = torch.ones((), dtype=torch.bool)
    if kind == "ba":
        return tba.solve_ba(*ranks.vo_args(p), tba.BAConfig(**cfg_kw),
                            obs_weight=w)
    W = p["T_W_B"].shape[0]
    if kind == "ba_marg":
        return tba.solve_ba_marginalized(
            *ranks.vo_args(p), ranks.prior_of(p, W, 6, torch.float64), yes,
            tba.BAConfig(**cfg_kw), obs_weight=w)
    if kind == "vio":
        return tvb.solve_vio_ba(*ranks.vio_args(p), tvb.VIOBAConfig(**cfg_kw),
                                obs_weight=w)
    return tvb.solve_vio_ba_marginalized(
        *ranks.vio_args(p), ranks.prior_of(p, W, 15, torch.float64), yes,
        tvb.VIOBAConfig(**cfg_kw), obs_weight=w)


def _result(fields, marg):
    """(result fields, prior fields or None) of a flattened case."""
    if not marg:
        return fields, None
    return ({k[2:]: v for k, v in fields.items() if k.startswith("0.")},
            {k[2:]: v for k, v in fields.items() if k.startswith("1.")})


def _close(a, b, what):
    """Within 1e-8 of max(1, max|b|)."""
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * scale, err_msg=what)


def _pose_key(res):
    return "state.T_W_B" if "state.T_W_B" in res else "T_W_B"


@pytest.mark.parametrize("name", JAX_CASES)
def test_float32_matches_jax_distributed(ranked, jax_results, name):
    kind = dict((c[0], c[1]) for c in CASES)[name]
    marg = kind.endswith("marg")
    got, gp = _result(_get(ranked[0], f"{name}.f32"), marg)
    want, wp = _result(jax_results[name], marg)
    assert bool(got["success"]) and bool(want["success"])
    pk = _pose_key(want)
    np.testing.assert_allclose(got[pk], want[pk], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["landmarks"], want["landmarks"],
                               rtol=1e-3, atol=1e-4)
    if kind.startswith("vio"):
        np.testing.assert_allclose(got["state.vel"], want["state.vel"],
                                   rtol=1e-2, atol=1e-3)
    if kind == "ba" and name != "ba_chi2":
        cost = float(want["final_cost"])
        assert abs(float(got["final_cost"]) - cost) <= 1e-4 * max(1.0, cost)
    if marg:
        assert bool(gp["valid"]) and bool(wp["valid"])
        np.testing.assert_allclose(gp["T0"], wp["T0"], rtol=1e-3, atol=1e-4)
        scale = max(1.0, float(np.abs(wp["H"]).max()))
        np.testing.assert_allclose(gp["H"] / scale, wp["H"] / scale,
                                   rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_float64_matches_single_device(ranked, inputs, name):
    _, kind, pre, cfg_kw = next(c for c in CASES if c[0] == name)
    marg = kind.endswith("marg")
    got, gp = _result(_get(ranked[0], f"{name}.f64"), marg)
    ref = {}
    ranks.flatten("r", _single_f64(kind, inputs[pre + "n"], cfg_kw), ref)
    want, wp = _result(_get(ref, "r"), marg)
    assert got.keys() == want.keys()
    for f in ("success", "status", "iterations"):
        assert int(got[f]) == int(want[f]), f
    for f, v in want.items():
        assert got[f].dtype == v.dtype, f
        if f == "metrics":
            # The gain ratio is a ratio of two small differences of
            # near-equal costs once converged: rounding shows at ~1e-6
            # relative (as in tests/test_torch_solvers.py).
            np.testing.assert_allclose(got[f][:, 4], v[:, 4], rtol=1e-4,
                                       atol=1e-9)
            got[f], v = np.delete(got[f], 4, 1), np.delete(v, 4, 1)
        _close(got[f], v, f)
    for f, v in (wp or {}).items():
        _close(gp[f], v, f)
    if name.startswith(("skip", "marg_skip")):
        assert not bool(got["success"])
        assert int(got["status"]) == tba.STATUS_SKIPPED
    else:
        assert bool(got["success"])


@pytest.mark.parametrize("name", ["skip", "marg_skip"])
def test_under_constrained_skip_keeps_input_and_prior(ranked, inputs, name):
    pre = dict((c[0], c[2]) for c in CASES)[name]
    got, gp = _result(_get(ranked[0], f"{name}.f32"), name == "marg_skip")
    assert not bool(got["success"])
    np.testing.assert_array_equal(got["T_W_B"], inputs[pre]["T_W_B"])
    np.testing.assert_array_equal(got["landmarks"], inputs[pre]["lms"])
    if gp is not None:
        assert not bool(gp["valid"])
        np.testing.assert_array_equal(gp["H"], 0.0)


def test_landmark_count_must_divide_world_size(ranked):
    assert all(bool(r["ba_bad_L"]) for r in ranked)


def test_ranks_return_the_same_result(ranked):
    assert ranked[0].keys() == ranked[1].keys()
    for k, v in ranked[0].items():
        np.testing.assert_array_equal(ranked[1][k], v, err_msg=k)


@pytest.mark.parametrize("dname", ["f32", "f64"])
def test_all_reduce_bytes_independent_of_landmarks(ranked, dname):
    """The same solve at 32 and 64 landmarks moves the same all-reduce
    bytes (O(W^2) payloads only)."""
    b32 = int(ranked[0][f"allreduce_bytes.ba.{dname}"])
    b64 = int(ranked[0][f"allreduce_bytes.ba_x2.{dname}"])
    assert b32 == b64 > 0
