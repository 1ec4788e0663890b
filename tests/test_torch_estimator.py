"""The port's stereo VO slice as a whole against the JAX package.

Setup: the ``__graft_entry__._tiny_setup`` scene and configuration (96x128,
32 slots, 3 levels, 8 KLT iterations, window 4; built here without the
compile cache that helper enables) driven by the rolling-image stereo
sequence of ``dryrun_multichip`` (left image rolled k px, right k+4 px). The
JAX step uses its Pallas KLT kernel in interpret mode
(``KLTConfig(backend="pallas")``); the port uses the plain PyTorch version of
its KLT kernel. Both run on the CPU in float32.

Tolerances:
  * per frame over the sequence: keyframe / PnP / BA flags and the track,
    landmark and occupancy counts equal; T_W_B within 1e-3 m and 1e-3 rad.
    The steps differ only in the order of fp32 sums (measured pose gap
    ~3e-6 over 12 frames); 1e-3 leaves room for that to compound.
  * one step from a converted JAX state: integer and boolean fields equal,
    float fields within 1e-4 (one step cannot compound).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import ba as jba
from rsvio_tpu.models import estimator as jest
from rsvio_tpu.models import frontend as jfe
from rsvio_tpu.models import pnp as jpnp
from rsvio_tpu.ops import cameras as jcam
from rsvio_tpu.ops import klt as jklt
from rsvio_tpu_torch.data import bench_scene
from rsvio_tpu_torch.models import ba as tba
from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.models import estimator_vio as tev
from rsvio_tpu_torch.models import frontend as tfe
from rsvio_tpu_torch.models import marginalization as tmarg
from rsvio_tpu_torch.models import mono_tracker as tmono
from rsvio_tpu_torch.models import pnp as tpnp
from rsvio_tpu_torch.ops import cameras as tcam
from rsvio_tpu_torch.ops import klt as tklt
from rsvio_tpu_torch.utils import config as tconfig
from rsvio_tpu_torch.utils import convert

torch.set_num_threads(2)

H, W = 96, 128
N_FRAMES = 10
POSE_TOL = 1e-3
STEP_TOL = 1e-4


def _jax_cfg():
    return jest.EstimatorConfig(
        frontend=jfe.FrontendConfig(
            capacity=32, cell_size=24, detect_margin=10,
            klt=jklt.KLTConfig(levels=3, max_iterations=8, backend="pallas")),
        window_size=4, image_shape=(H, W))


def _torch_cfg():
    return test_.EstimatorConfig(
        frontend=tfe.FrontendConfig(
            capacity=32, cell_size=24, detect_margin=10,
            klt=tklt.KLTConfig(levels=3, max_iterations=8)),
        window_size=4, image_shape=(H, W))


def _frames():
    rng = np.random.default_rng(0)
    tex = (np.kron(rng.uniform(0, 1, (H // 8, W // 8)), np.ones((8, 8))) * 140
           + np.kron(rng.uniform(0, 1, (H // 4, W // 4)), np.ones((4, 4))) * 70
           + 40).astype(np.float32)
    return [(np.roll(tex, -k, axis=1), np.roll(tex, -(k + 4), axis=1))
            for k in range(N_FRAMES)]


def _jax_rig():
    params = jcam.pack_params(jcam.PINHOLE_RADTAN, [100.0, 100.0, W / 2, H / 2],
                              [0, 0, 0, 0])
    return jest.make_rig(params, params, jnp.eye(4, dtype=jnp.float32),
                         jnp.eye(4, dtype=jnp.float32).at[0, 3].set(0.11))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """JAX states (numpy) before each frame and outputs of each frame."""
    cfg = _jax_cfg()
    step = jest.make_estimator_step(cfg)
    rig = _jax_rig()
    state = jest.init_state(cfg)
    states, outs = [_np(state)], []
    for a, b in _frames():
        state, out = step(state, rig, jnp.asarray(a), jnp.asarray(b))
        states.append(_np(state))
        outs.append(_np(out))
    return dict(rig=_np(rig), states=states, outs=outs)


@pytest.fixture(scope="module")
def torch_step():
    return test_.make_estimator_step(_torch_cfg())


FLAGS = ("is_keyframe", "pnp_success", "ba_success", "n_tracked",
         "n_landmarks", "n_alive", "pose_ok")


def _pose_err(Tt, Tj):
    dt = float(np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]))
    c = (np.trace(Tj[:3, :3].T @ Tt[:3, :3]) - 1.0) / 2.0
    return dt, float(np.arccos(np.clip(c, -1.0, 1.0)))


def _cfg_dict(c):
    return {k: (_cfg_dict(v) if hasattr(v, "_fields") else v)
            for k, v in c._asdict().items()}


@pytest.mark.parametrize("pair", [
    (jklt.KLTConfig, tklt.KLTConfig), (jfe.FrontendConfig, tfe.FrontendConfig),
    (jpnp.PnPConfig, tpnp.PnPConfig), (jba.BAConfig, tba.BAConfig),
    (jest.EstimatorConfig, test_.EstimatorConfig)],
    ids=lambda p: p[0].__name__)
def test_config_fields_and_defaults_equal(pair):
    cj, ct = pair
    assert cj._fields == ct._fields
    assert _cfg_dict(cj()) == _cfg_dict(ct())


def test_state_and_output_fields_equal():
    for cj, ct in ((jest.EstimatorState, test_.EstimatorState),
                   (jest.FrameOutput, test_.FrameOutput),
                   (jest.MotionOut, test_.MotionOut),
                   (jest.CameraRig, test_.CameraRig),
                   (jfe.FeatureTable, tfe.FeatureTable)):
        assert cj._fields == ct._fields
    assert test_.STAGE_NAMES == jest.STAGE_NAMES


def test_sequence_matches_jax(jax_run, torch_step):
    """~10 frames through both steps from the same initial state."""
    rig = convert.rig_from_numpy(jax_run["rig"], device="cpu")
    state = test_.init_state(_torch_cfg(), device="cpu")
    saw_ba = False
    for k, (a, b) in enumerate(_frames()):
        state, out = torch_step(state, rig, torch.from_numpy(a),
                                torch.from_numpy(b))
        oj = jax_run["outs"][k]
        for f in FLAGS:
            assert int(getattr(out, f)) == int(getattr(oj, f)), (k, f)
        dt, dr = _pose_err(out.T_W_B.numpy(), oj.T_W_B)
        assert dt <= POSE_TOL and dr <= POSE_TOL, (k, dt, dr)
        saw_ba = saw_ba or bool(out.ba_success)
    assert saw_ba and int(out.n_tracked) >= 10
    assert float(out.T_W_B[0, 3]) > 0.05, "the rig must have moved"


def _compare_states(st, sj):
    """Field by field: integer/bool exact, floats within STEP_TOL."""
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
    for f in test_.EstimatorState._fields:
        t, j = getattr(st, f), getattr(sj, f)
        if f in ("table", "marg_prior"):
            for g in type(t)._fields:
                cmp(f"{f}.{g}", getattr(t, g), getattr(j, g))
        elif f in ("pyr0", "pyr1"):
            for lvl, (a, b) in enumerate(zip(t, j)):
                cmp(f"{f}[{lvl}]", a, b)
        else:
            cmp(f, t, j)


@pytest.mark.parametrize("kind", ["keyframe_with_ba", "non_keyframe"])
def test_one_step_from_converted_state(jax_run, torch_step, kind):
    """Start the port from JAX's state before frame k, step frame k, and
    compare the new state with JAX's state after frame k."""
    outs = jax_run["outs"]
    want = {"keyframe_with_ba": lambda o: bool(o.is_keyframe & o.ba_success),
            "non_keyframe": lambda o: not bool(o.is_keyframe)}[kind]
    ks = [k for k in range(2, N_FRAMES) if want(outs[k])]
    assert ks, f"the sequence has no {kind} frame"
    k = ks[0]
    state = convert.state_from_numpy(jax_run["states"][k], device="cpu")
    rig = convert.rig_from_numpy(jax_run["rig"], device="cpu")
    a, b = _frames()[k]
    new, out = torch_step(state, rig, torch.from_numpy(a), torch.from_numpy(b))
    for f in FLAGS:
        assert int(getattr(out, f)) == int(getattr(outs[k], f)), f
    _compare_states(convert.state_to_numpy(new), jax_run["states"][k + 1])


def test_convert_round_trip(jax_run):
    sj = jax_run["states"][5]
    st = convert.state_from_numpy(sj, device="cpu")
    assert st.table.alive.dtype == torch.bool
    assert st.kf_count.dtype == torch.int32 and st.kf_count.dim() == 0
    _compare_states(convert.state_to_numpy(st), sj)


def test_split_step_matches_fused_step(torch_step):
    cfg = _torch_cfg()
    split = test_.make_estimator_split_step(cfg)
    rig = convert.rig_from_numpy(_np(_jax_rig()), device="cpu")
    s1 = s2 = test_.init_state(cfg, device="cpu")
    for a, b in _frames()[:5]:
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        s1, o1 = torch_step(s1, rig, a, b)
        s2, o2, times = split(s2, rig, a, b)
        assert set(times) == set(test_.STAGE_NAMES)
        assert torch.equal(o1.T_W_B, o2.T_W_B)
        assert int(o1.n_alive) == int(o2.n_alive)


# Every EstimatorConfig option is ported: the shipped configs' options are
# held to JAX by tests/test_torch_options.py, the window options
# (marginalization, culling, birth refinement, the constant-velocity seed,
# the scene-flow gate, track_before_full=False) by
# tests/test_torch_options_window.py.


@pytest.mark.parametrize("opt", [
    dict(pnp_prior_adaptive=True, pnp=dict(motion_prior_weight=20.0)),
    dict(vision_weight_adaptive=True, use_obs_weights=True),
    dict(pnp_prior_adaptive=True, pnp=dict(ransac_hypotheses=8)),
    dict(vision_weight_adaptive=True, pnp=dict(ransac_hypotheses=8)),
], ids=["prior_without_gate", "vision_without_gate", "prior_without_weight",
        "vision_without_weights"])
def test_inert_adaptive_knobs_raise_as_in_jax(opt):
    """The adaptive defenses need the gate and their channel: both steps
    refuse the config with ValueError."""
    pnp = opt.pop("pnp", {})
    with pytest.raises(ValueError):
        jest.make_estimator_step(jest.EstimatorConfig(
            pnp=jpnp.PnPConfig(**pnp), **opt))
    with pytest.raises(ValueError):
        test_.make_estimator_step(test_.EstimatorConfig(
            pnp=tpnp.PnPConfig(**pnp), **opt))


TRACKER_OPTIONS = [
    pytest.param(dict(detect_mode="nms", nms_radius=8, nms_max_new=24),
                 dict(), id="detect_nms"),
    pytest.param(dict(), dict(track_rotation=True), id="track_rotation"),
    pytest.param(dict(), dict(interpolation="bicubic"), id="bicubic"),
    pytest.param(dict(), dict(backend="xla"), id="klt_gather_path"),
]


@pytest.mark.parametrize("fe_opt,klt_opt", TRACKER_OPTIONS)
def test_tracker_options_run(fe_opt, klt_opt):
    """The tracker options the port now implements run through the whole
    step: tracks survive, the pose moves along +x and stays finite."""
    base = _torch_cfg()
    fe = base.frontend._replace(klt=base.frontend.klt._replace(**klt_opt),
                                **fe_opt)
    cfg = base._replace(frontend=fe)
    step = test_.make_estimator_step(cfg)
    rig = convert.rig_from_numpy(_np(_jax_rig()), device="cpu")
    state = test_.init_state(cfg, device="cpu")
    for a, b in _frames()[:5]:
        state, out = step(state, rig, torch.from_numpy(a),
                          torch.from_numpy(b))
    assert int(out.n_tracked) >= 5
    assert bool(torch.isfinite(out.T_W_B).all())
    assert float(out.T_W_B[0, 3]) > 0.01


@pytest.fixture(scope="module")
def jax_nms_run():
    """JAX outputs of each frame with NMS detection."""
    cfg = _jax_cfg()
    cfg = cfg._replace(frontend=cfg.frontend._replace(
        detect_mode="nms", nms_radius=8, nms_max_new=24))
    step = jest.make_estimator_step(cfg)
    rig = _jax_rig()
    state = jest.init_state(cfg)
    outs = []
    for a, b in _frames()[:6]:
        state, out = step(state, rig, jnp.asarray(a), jnp.asarray(b))
        outs.append(_np(out))
    return outs


def test_nms_sequence_matches_jax(jax_nms_run):
    """The frontend's NMS detection mode over 6 frames of the step."""
    cfg = _torch_cfg()
    cfg = cfg._replace(frontend=cfg.frontend._replace(
        detect_mode="nms", nms_radius=8, nms_max_new=24))
    step = test_.make_estimator_step(cfg)
    rig = convert.rig_from_numpy(_np(_jax_rig()), device="cpu")
    state = test_.init_state(cfg, device="cpu")
    for k, (a, b) in enumerate(_frames()[:6]):
        state, out = step(state, rig, torch.from_numpy(a),
                          torch.from_numpy(b))
        oj = jax_nms_run[k]
        for f in FLAGS:
            assert int(getattr(out, f)) == int(getattr(oj, f)), (k, f)
        dt, dr = _pose_err(out.T_W_B.numpy(), oj.T_W_B)
        assert dt <= POSE_TOL and dr <= POSE_TOL, (k, dt, dr)
    assert int(out.n_tracked) >= 5


def _default_device_calls():
    """Each entry point whose device defaults to CUDA, called with that
    default on CPU-made inputs."""
    cfg = _torch_cfg()
    rig_np = _np(_jax_rig())
    state_np = convert.state_to_numpy(test_.init_state(cfg, device="cpu"))
    vcfg = tev.VIOEstimatorConfig(base=cfg)
    vio_np = convert.vio_state_to_numpy(tev.init_vio_state(vcfg,
                                                           device="cpu"))
    return {
        "init_state": (test_.init_state, lambda: test_.init_state(cfg)),
        "init_table": (tfe.init_table, lambda: tfe.init_table(8)),
        "empty_prior": (tmarg.empty_prior, lambda: tmarg.empty_prior(4, 6)),
        "make_rig": (bench_scene.make_rig, lambda: bench_scene.make_rig()),
        "rig_from_numpy": (convert.rig_from_numpy,
                           lambda: convert.rig_from_numpy(rig_np)),
        "state_from_numpy": (convert.state_from_numpy,
                             lambda: convert.state_from_numpy(state_np)),
        "pack_params": (tcam.pack_params, lambda: tcam.pack_params(
            tcam.PINHOLE_RADTAN, [1.0, 1.0, 0.0, 0.0], [])),
        "init_mono_table": (tmono.init_mono_table,
                            lambda: tmono.init_mono_table(8)),
        "make_estimator_config": (
            tconfig.make_estimator_config,
            lambda: tconfig.make_estimator_config(tconfig.Config())),
        "init_vio_state": (tev.init_vio_state,
                           lambda: tev.init_vio_state(vcfg)),
        "initialize_vio_state": (
            tev.initialize_vio_state,
            lambda: tev.initialize_vio_state(
                vcfg, np.zeros((5, 3)), np.tile([0.0, 0.0, 9.81], (5, 1)))),
        "vio_state_from_numpy": (
            convert.vio_state_from_numpy,
            lambda: convert.vio_state_from_numpy(vio_np)),
        "make_estimator_config_vio": (
            tconfig.make_estimator_config,
            lambda: tconfig.make_estimator_config(tconfig.Config(),
                                                  kind="vio")),
        "make_compiled_estimator_step": (
            test_.make_compiled_estimator_step,
            lambda: test_.make_compiled_estimator_step(cfg)),
        "make_compiled_vio_estimator_step": (
            tev.make_compiled_vio_estimator_step,
            lambda: tev.make_compiled_vio_estimator_step(vcfg)),
        "make_compiled_mono_step": (
            tmono.make_compiled_mono_step,
            lambda: tmono.make_compiled_mono_step(tmono.MonoTrackerConfig(),
                                                  lambda img: (img,))),
    }


@pytest.mark.parametrize("name", [
    "init_state", "init_table", "empty_prior", "make_rig", "rig_from_numpy",
    "state_from_numpy", "pack_params", "init_mono_table",
    "make_estimator_config", "init_vio_state", "initialize_vio_state",
    "vio_state_from_numpy", "make_estimator_config_vio",
    "make_compiled_estimator_step", "make_compiled_vio_estimator_step",
    "make_compiled_mono_step"])
def test_entry_points_default_to_cuda(name):
    """Entry points run on the card unless the caller asks for the CPU:
    their device default is CUDA, and without a card the default raises
    rather than falling back to the CPU."""
    fn, call = _default_device_calls()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert call() is not None
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
