"""The port's config loader (rsvio_tpu_torch/utils/config.py) against the JAX
package's (rsvio_tpu/utils/config.py, which reads YAML with PyYAML).

* ``parse_yaml``: the dict of every file under config/ equals PyYAML's
  ``safe_load`` of the same stripped text, and so do small documents that
  hit each YAML 1.1 scalar rule the reader implements; input outside the
  supported subset raises ValueError.
* ``load_config``: the same dataclasses, field by field, for every file.
* ``make_estimator_config``: for the five stereo files, the port's
  EstimatorConfig equals JAX's field by field, and the rig tensors are
  exactly JAX's (float32, and float64 under ``precision: f64``).
* Bad input raises as in JAX: precision, dynamic_flow_center.
"""

import dataclasses
import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from rsvio_tpu.utils import config as jcfg
from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.utils import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = sorted(os.path.basename(p)
             for p in glob.glob(os.path.join(ROOT, "config", "*.yaml")))
STEREO = ["euroc_vio.yaml", "euroc_vo_dynamic.yaml", "euroc_vo_adaptive.yaml",
          "4seasons.yaml", "tum_vi.yaml"]


def _path(name):
    return os.path.join(ROOT, "config", name)


def _stripped(name):
    with open(_path(name)) as f:
        return "\n".join(ln for ln in f.read().splitlines()
                         if not ln.strip().startswith("%YAML"))


def test_all_shipped_files_are_covered():
    assert ALL == sorted(STEREO + ["tartanair.yaml"])


@pytest.mark.parametrize("name", ALL)
def test_loader_matches_pyyaml(name):
    assert tcfg.load_yaml_stripped(_path(name)) == \
        yaml.safe_load(_stripped(name))


SCALARS = [
    "a: 1e5", "a: 1.0e5", "a: 1.0e-6", "a: 1.76187114e-05", "a: -3.5e-05",
    "a: 12", "a: -0", "a: +7", "a: 0.0", "a: 1.", "a: .5", "a: -2.25",
    "a: true", "a: False", "a: on", "a: Off", "a: yes", "a: NO",
    "a: ~", "a:", "a: null", "a: +.inf", "a: -.Inf", "a: f32",
    "a: pinhole-radtan", "a: text with spaces", "a: x#y", "a: 08",
    "a: 'x''y'", 'a: "q\\"x" # c', "a: 'EUCM'  # trailing",
    "a: [1, 2,\n     3]  # t", "a: []", "a: [a, 'b, c', \"d\", 4.5, on]",
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3", "---\na: 1", "'k': v",
    "# only a comment\n\na: 1\n# another\nb: [1,\n  # inside\n  2]",
]


@pytest.mark.parametrize("doc", SCALARS)
def test_loader_scalar_rules_match_pyyaml(doc):
    assert tcfg.parse_yaml(doc) == yaml.safe_load(doc)


OUTSIDE = [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  text", "a: >\n  text",
    "- 1\n- 2", "a:\n  - 1", "a: {b: 1}", "a: [[1], 2]", "a: [1, 2",
    "a: [1,, 2]", "a: 1_000", "a: 0x1F", "a: 017", "a: 1:30",
    "a: 2020-01-01", "a: b: c", "a: 1\n  b: 2", "\ta: 1", "  a: 1",
    "a: 1\n---\nb: 2", "--- a", "a: 'open", "a: \"\\x41\"", "just text",
    "a: =", "<<: 1",
]


@pytest.mark.parametrize("doc", OUTSIDE)
def test_loader_raises_outside_its_subset(doc):
    with pytest.raises(ValueError):
        tcfg.parse_yaml(doc)


@pytest.mark.parametrize("name", ALL)
def test_load_config_matches_jax(name):
    assert dataclasses.asdict(tcfg.load_config(_path(name))) == \
        dataclasses.asdict(jcfg.load_config(_path(name)))


def _cfg_dict(c):
    return {k: (_cfg_dict(v) if hasattr(v, "_fields") else v)
            for k, v in c._asdict().items()}


def _assert_rig_equal(rt, rj, dtype):
    for f in test_.CameraRig._fields:
        t, j = getattr(rt, f), np.asarray(getattr(rj, f))
        assert t.dtype == dtype and t.device.type == "cpu", f
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f)


@pytest.mark.parametrize("name", STEREO)
def test_make_estimator_config_matches_jax(name):
    cfg_t = tcfg.load_config(_path(name))
    ecfg_t, rig_t = tcfg.make_estimator_config(cfg_t, device="cpu")
    ecfg_j, rig_j = jcfg.make_estimator_config(jcfg.load_config(_path(name)))
    assert ecfg_t._fields == ecfg_j._fields
    assert _cfg_dict(ecfg_t) == _cfg_dict(ecfg_j)
    _assert_rig_equal(rig_t, rig_j, torch.float32)
    # Every option these files switch on is ported: the step builds.
    test_.make_estimator_step(ecfg_t)


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_f64_precision_gives_a_float64_rig(tmp_path):
    text = _stripped("tum_vi.yaml").replace("precision: f32",
                                            "precision: f64")
    p = _write(tmp_path, "tum_vi_f64.yaml", text)
    ecfg_t, rig_t = tcfg.make_estimator_config(tcfg.load_config(p),
                                               device="cpu")
    with jax.enable_x64(True):
        ecfg_j, rig_j = jcfg.make_estimator_config(jcfg.load_config(p))
        rig_j = jax.tree_util.tree_map(np.asarray, rig_j)
    assert _cfg_dict(ecfg_t) == _cfg_dict(ecfg_j)
    _assert_rig_equal(rig_t, rig_j, torch.float64)


@pytest.mark.parametrize("text", [
    "precision: f16\n", "precision: double\n",
    "solver:\n  dynamic_flow_center: of\n",
    "solver:\n  dynamic_flow_center: 1\n"])
def test_bad_values_raise_as_in_jax(tmp_path, text):
    p = _write(tmp_path, "bad.yaml", text)
    with pytest.raises(ValueError):
        jcfg.load_config(p)
    with pytest.raises(ValueError):
        tcfg.load_config(p)


@pytest.mark.parametrize("value,want", [("on", True), ("off", False),
                                        ("auto", True), ("'ON'", True)])
def test_dynamic_flow_center_matches_jax(tmp_path, value, want):
    p = _write(tmp_path, "dfc.yaml",
               f"solver:\n  dynamic_flow_center: {value}\n")
    ct, cj = tcfg.load_config(p), jcfg.load_config(p)
    assert ct.solver.dynamic_flow_center == cj.solver.dynamic_flow_center
    et, _ = tcfg.make_estimator_config(ct, device="cpu")
    ej, _ = jcfg.make_estimator_config(cj)
    assert et.dynamic_flow_center == ej.dynamic_flow_center == want


def test_numeric_strings_are_coerced_as_in_jax(tmp_path):
    """YAML 1.1 reads 1e4 as a string; _fill coerces it by the field's
    default type on both sides."""
    p = _write(tmp_path, "coerce.yaml",
               "solver:\n  bias_accel_weight: 1e4\n  ransac_min_inliers: '9'\n"
               "tracker:\n  min_corner_score: 12\n")
    ct, cj = tcfg.load_config(p), jcfg.load_config(p)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.solver.bias_accel_weight == 1e4
    assert ct.solver.ransac_min_inliers == 9
    assert isinstance(ct.tracker.min_corner_score, float)


def test_vio_kind_is_not_ported():
    """kind="vio" (ported now): the base config and rig equal JAX's, and
    ``dynamic_flow_center: auto`` resolves off for VIO, on for VO; any
    other kind raises ValueError."""
    cfg = tcfg.load_config(_path("euroc_vio.yaml"))
    cfg.solver.dynamic_flow = 0.02
    ecfg_t, rig_t = tcfg.make_estimator_config(cfg, kind="vio",
                                               device="cpu")
    cfg_j = jcfg.load_config(_path("euroc_vio.yaml"))
    cfg_j.solver.dynamic_flow = 0.02
    ecfg_j, rig_j = jcfg.make_estimator_config(cfg_j, kind="vio")
    assert _cfg_dict(ecfg_t) == _cfg_dict(ecfg_j)
    _assert_rig_equal(rig_t, rig_j, torch.float32)
    assert ecfg_t.dynamic_flow_center is False
    assert tcfg.make_estimator_config(cfg, kind="vo", device="cpu")[0] \
        .dynamic_flow_center is True
    with pytest.raises(ValueError):
        tcfg.make_estimator_config(cfg, kind="mono", device="cpu")


def test_port_imports_neither_jax_nor_yaml_nor_rsvio_tpu():
    """Every module of the port, and the config loader on every shipped
    file, in a process where importing jax, yaml or rsvio_tpu fails."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'yaml', 'rsvio_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import rsvio_tpu_torch\n"
        "for mod in pkgutil.walk_packages(rsvio_tpu_torch.__path__,\n"
        "                                 'rsvio_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "from rsvio_tpu_torch.utils import config as c\n"
        f"for n in {ALL!r}:\n"
        f"    c.load_config({os.path.join(ROOT, 'config')!r} + '/' + n)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# The rolling-image scene of tests/test_torch_estimator.py moves the rig
# 1 px a frame at fx = 100 with a 4 px stereo disparity over a 0.11 m
# baseline: 0.0275 m a frame along x.
ROLL_STEP_M = 0.11 / 4.0


def _small(ecfg, klt_backend):
    """A config from a shipped file cut to that scene: 96x128, 32 slots,
    24 px cells, 3 levels, 8 KLT iterations, window 4; every solver,
    tracker-policy and option field as in the file."""
    fe = ecfg.frontend
    return ecfg._replace(
        frontend=fe._replace(
            capacity=32, cell_size=24, detect_margin=10, relax_floor_below=16,
            klt=fe.klt._replace(levels=3, max_iterations=8,
                                backend=klt_backend)),
        window_size=4, image_shape=(96, 128))


def test_dynamic_profile_lags_in_jax_and_in_the_port():
    """euroc_vo_dynamic.yaml's motion prior (weight 20, anchored at the
    previous pose) outweighs the visual information of a clean scene, so
    PnP recovers only part of each frame's motion: its own comment's
    trade-off ("the prior lags the true motion"). Both steps lag alike,
    frame by frame, far beyond the 2 % drift floor of the default
    profile."""
    from test_torch_estimator import (FLAGS, POSE_TOL, _frames, _jax_rig,
                                      _np, _pose_err)
    import jax.numpy as jnp
    from rsvio_tpu.models import estimator as jest
    from rsvio_tpu_torch.utils import convert

    path = _path("euroc_vo_dynamic.yaml")
    ecfg_j, _ = jcfg.make_estimator_config(jcfg.load_config(path))
    ecfg_t, _ = tcfg.make_estimator_config(tcfg.load_config(path),
                                           device="cpu")
    ecfg_j, ecfg_t = _small(ecfg_j, "pallas"), _small(ecfg_t, "auto")
    assert ecfg_t.pnp.motion_prior_weight == 20.0
    rig_j = _jax_rig()
    step_j = jest.make_estimator_step(ecfg_j)
    step_t = test_.make_estimator_step(ecfg_t)
    rig_t = convert.rig_from_numpy(_np(rig_j), device="cpu")
    sj, st = jest.init_state(ecfg_j), test_.init_state(ecfg_t, device="cpu")
    for k, (a, b) in enumerate(_frames()):
        sj, oj = step_j(sj, rig_j, jnp.asarray(a), jnp.asarray(b))
        st, ot = step_t(st, rig_t, torch.from_numpy(a), torch.from_numpy(b))
        oj = _np(oj)
        for f in FLAGS:
            assert int(getattr(ot, f)) == int(getattr(oj, f)), (k, f)
        dt, dr = _pose_err(ot.T_W_B.numpy(), oj.T_W_B)
        assert dt <= POSE_TOL and dr <= POSE_TOL, (k, dt, dr)
    truth = ROLL_STEP_M * k
    drift = abs(float(ot.T_W_B[0, 3]) - truth) / truth
    assert drift > 0.1, drift
