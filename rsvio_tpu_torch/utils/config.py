"""YAML configuration: the port's counterpart of rsvio_tpu/utils/config.py.

The same schema (camera / keyframe_management / feature_detection /
optimization / tracker / solver / imu sections, ``%YAML:1.0`` directive
stripping, unknown keys ignored), the same dataclasses, fields and defaults,
and ``make_estimator_config`` building the port's ``EstimatorConfig`` and
``CameraRig``.

The port does not depend on PyYAML (a GPU machine is not promised it), so
``parse_yaml`` reads YAML itself. It reads the subset the repo's config
files use and raises ``ValueError`` on anything else: block mappings; plain
scalars resolved as YAML 1.1 resolves them (PyYAML's ``safe_load``:
``true``/``on``/``yes`` are booleans, ``1e5`` without a dot or a signed
exponent stays a string, ``~`` and an empty value are null); single- and
double-quoted strings; flow lists of scalars that may span lines; ``#``
comments, whole-line or trailing; one leading ``---``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

import numpy as np

# --------------------------------------------------------------------------
# YAML subset reader
# --------------------------------------------------------------------------

_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_INF_NAN = {**dict.fromkeys((".inf", ".Inf", ".INF", "+.inf", "+.Inf",
                             "+.INF"), float("inf")),
            **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), float("-inf")),
            **dict.fromkeys((".nan", ".NaN", ".NAN"), float("nan"))}
# Plain scalars YAML 1.1 gives another type that this reader does not
# build: binary / octal / hex / sexagesimal / underscored numbers and
# timestamps. They raise rather than come back as strings.
_UNSUPPORTED = re.compile(
    r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
    r"|(?=[^_]*_)[-+]?[0-9_.]+(?:[eE][-+][0-9]+)?$"
    r"|[0-9]{4}-[0-9][0-9]?-[0-9][0-9]?")
_INDICATORS = "[]{}#&*!|>%@`,"


def _err(lineno, msg):
    return ValueError(f"YAML line {lineno}: {msg}")


def _plain(text: str, lineno: int):
    """Resolve a plain scalar as YAML 1.1 does."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if text in _INF_NAN:
        return _INF_NAN[text]
    if text in ("=", "<<") or _UNSUPPORTED.match(text):
        raise _err(lineno, f"unsupported scalar {text!r}")
    if text[0] in _INDICATORS or (text[0] in "-?:" and
                                  (len(text) == 1 or text[1] == " ")):
        raise _err(lineno, f"unsupported YAML syntax {text!r}")
    if ": " in text or text.endswith(":"):
        raise _err(lineno, f"unexpected mapping in {text!r}")
    return text


def _quoted(text: str, lineno: int):
    """A quoted scalar that makes up all of `text`."""
    q = text[0]
    body, i = [], 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                body.append("'")
                i += 2
                continue
            break
        if q == '"' and c == "\\":
            esc = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/"}
            nxt = text[i + 1:i + 2]
            if nxt not in esc:
                raise _err(lineno, f"unsupported escape in {text!r}")
            body.append(esc[nxt])
            i += 2
            continue
        if q == '"' and c == '"':
            break
        body.append(c)
        i += 1
    else:
        raise _err(lineno, f"unterminated string {text!r}")
    if text[i + 1:].strip():
        raise _err(lineno, f"text after a quoted scalar in {text!r}")
    return "".join(body)


def _scalar(text: str, lineno: int):
    text = text.strip()
    if text[:1] in ("'", '"'):
        return _quoted(text, lineno)
    return _plain(text, lineno)


def _split_flow(body: str, lineno: int):
    """Comma-separated items of a flow list's body, quotes respected."""
    items, cur, q = [], [], None
    for c in body:
        if q:
            cur.append(c)
            if c == q:
                q = None
        elif c in "'\"" and not "".join(cur).strip():
            q = c
            cur.append(c)
        elif c in "[]{}":
            raise _err(lineno, "nested flow collections are not supported")
        elif c == ",":
            items.append("".join(cur).strip())
            cur = []
        else:
            cur.append(c)
    items.append("".join(cur).strip())
    if items[-1] == "":          # "[a, b,]" and "[]"
        items.pop()
    if any(it == "" for it in items):
        raise _err(lineno, "empty item in a flow list")
    return [_scalar(it, lineno) for it in items]


def _strip_comment(line: str) -> str:
    q = None
    for i, c in enumerate(line):
        if q:
            if c == q:
                q = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[,:"):
            q = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _logical_lines(text: str):
    """(lineno, indent, content) per non-blank line, comments removed and
    the lines of a multi-line flow list joined into one."""
    out = []
    pending = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t"):
            raise _err(lineno, "tabs are not allowed in indentation")
        if pending is not None:
            pending[2] += " " + body
        else:
            pending = [lineno, len(line) - len(body), body]
        if pending[2].count("[") == pending[2].count("]"):
            out.append(tuple(pending))
            pending = None
    if pending is not None:
        raise _err(pending[0], "unterminated flow list")
    if out and out[0][2].startswith("---"):
        if out[0][2] != "---":
            raise _err(out[0][0], "content after '---'")
        out = out[1:]
    for lineno, _, body in out:
        if body.startswith(("---", "...")):
            raise _err(lineno, "multiple documents are not supported")
    return out


def _split_key(body: str, lineno: int):
    """'key: value' -> (key, value text); 'key:' -> (key, '')."""
    q = None
    for i, c in enumerate(body):
        if q:
            if c == q:
                q = None
        elif c in "'\"" and i == 0:
            q = c
        elif c == ":" and (i + 1 == len(body) or body[i + 1] == " "):
            return _scalar(body[:i], lineno), body[i + 1:].strip()
    raise _err(lineno, f"expected 'key: value', got {body!r}")


def _mapping(lines, i: int, indent: int):
    out = {}
    while i < len(lines):
        lineno, ind, body = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise _err(lineno, "unexpected indentation")
        key, value = _split_key(body, lineno)
        i += 1
        if value:
            out[key] = (_split_flow(value[1:-1], lineno)
                        if value[0] == "[" and value[-1] == "]"
                        else _scalar(value, lineno))
        elif i < len(lines) and lines[i][1] > indent:
            out[key], i = _mapping(lines, i, lines[i][1])
        else:
            out[key] = None
    return out, i


def parse_yaml(text: str):
    """Parse a YAML document of the supported subset into nested dicts
    (None for an empty document). Raises ValueError outside the subset."""
    lines = _logical_lines(text)
    if not lines:
        return None
    if lines[0][1] != 0:
        raise _err(lines[0][0], "the document must start at column 0")
    data, _ = _mapping(lines, 0, 0)
    return data


# --------------------------------------------------------------------------
# Dataclasses (same fields and defaults as rsvio_tpu/utils/config.py; see
# there for what each one means)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CameraConfig:
    image_width: int = 752
    image_height: int = 480
    left_intrinsics: List[float] = dataclasses.field(default_factory=list)
    left_distortion: List[float] = dataclasses.field(default_factory=list)
    right_intrinsics: List[float] = dataclasses.field(default_factory=list)
    right_distortion: List[float] = dataclasses.field(default_factory=list)
    left_model: str = "pinhole-radtan"
    right_model: str = "pinhole-radtan"
    T_B_Cl: List[float] = dataclasses.field(
        default_factory=lambda: list(np.eye(4).ravel()))
    T_B_Cr: List[float] = dataclasses.field(
        default_factory=lambda: list(np.eye(4).ravel()))

    def T_B_Cl_matrix(self) -> np.ndarray:
        return np.asarray(self.T_B_Cl, dtype=np.float64).reshape(4, 4)

    def T_B_Cr_matrix(self) -> np.ndarray:
        return np.asarray(self.T_B_Cr, dtype=np.float64).reshape(4, 4)


@dataclasses.dataclass
class KeyframeManagementConfig:
    keyframe_window_size: int = 10
    translation_threshold: float = 0.05
    rotation_threshold: float = 0.05
    track_before_full: bool = True


@dataclasses.dataclass
class FeatureDetectionConfig:
    grid_size: int = 50
    max_features_per_grid: int = 1
    optical_flow_max_iterations: int = 20
    optical_flow_convergence_threshold: float = 0.01


@dataclasses.dataclass
class OptimizationConfig:
    pnp_max_iterations: int = 10
    bundle_adjustment_max_iterations: int = 20


@dataclasses.dataclass
class TrackerConfig:
    pyramid_levels: int = 6
    bidir_threshold_sq: float = 0.4
    detect_margin: int = 19
    min_corner_score: float = 10.0
    feature_capacity: int = 256
    relax_floor_below: int = -1      # -1 = auto (feature_capacity // 2)
    relaxed_min_score: float = 1.0
    relax_max_per_cell: int = 3
    track_rotation: bool = False
    residual_mode: str = "lssd"
    lm_lambda: float = 0.0
    interpolation: str = "bilinear"
    backend: str = "auto"
    detect_mode: str = "grid"
    nms_radius: int = 10
    nms_max_new: int = 128
    score_weight_floor: float = 0.05
    score_weight_power: float = 1.0
    score_weight_ref: float = 10.0
    coarse_level_policy: str = "tolerant"


@dataclasses.dataclass
class ImuConfig:
    gyroscope_noise_density: float = 1.7e-4
    accelerometer_noise_density: float = 2.0e-3
    gyroscope_random_walk: float = 1.9e-5
    accelerometer_random_walk: float = 3.0e-3


@dataclasses.dataclass
class SolverConfig:
    huber_delta: float = 2.0
    cost_tol: float = 1e-6
    param_tol: float = 1e-9
    cull_reproj_threshold: float = 0.0
    chi2_gate: float = 0.0
    chi2_gate_iter: int = 1
    pnp_motion_prior: float = 0.0
    min_lm_span: int = 1
    ransac_hypotheses: int = 0
    ransac_threshold: float = 8e-3
    ransac_min_inliers: int = 12
    ransac_kill_outliers: bool = True
    pnp_prior_adaptive: bool = False
    vision_weight_adaptive: bool = False
    health_floor: float = 0.1
    health_f_lo: float = 0.5
    health_f_hi: float = 0.9
    health_recover: float = 1.0
    dynamic_flow: float = 0.0
    dynamic_flow_decay: float = 0.7
    dynamic_flow_min_n: int = 2
    dynamic_flow_center: str = "auto"   # auto / on / off
    score_weighted_obs: bool = False
    pnp_cv_predict: bool = False
    marginalization: bool = False
    bias_gyro_weight: float = 1e3
    bias_accel_weight: float = 1e2
    bias_gyro_weight_desert: float = 0.0
    bias_accel_weight_desert: float = 0.0


@dataclasses.dataclass
class Config:
    precision: str = "f32"
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    keyframe_management: KeyframeManagementConfig = dataclasses.field(
        default_factory=KeyframeManagementConfig)
    feature_detection: FeatureDetectionConfig = dataclasses.field(
        default_factory=FeatureDetectionConfig)
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    imu: ImuConfig = dataclasses.field(default_factory=ImuConfig)


def _fill(cls, data: Optional[dict]):
    """A dataclass from a dict, unknown keys ignored. Numeric fields are
    coerced to the default's type: YAML 1.1 reads ``1e4`` (no dot) as a
    string."""
    if not isinstance(data, dict):
        return cls()
    defaults = {f.name: f.default for f in dataclasses.fields(cls)}
    out = {}
    for k, v in data.items():
        if k not in defaults:
            continue
        d = defaults[k]
        if type(d) is float and isinstance(v, (int, str)):
            v = float(v)
        elif type(d) is int and isinstance(v, str):
            v = int(v)
        out[k] = v
    return cls(**out)


def load_yaml_stripped(path: str) -> dict:
    """Parse a YAML file, dropping the OpenCV-style ``%YAML:1.0`` directive
    lines the reference configs carry."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()
                 if not ln.strip().startswith("%YAML")]
    return parse_yaml("\n".join(lines)) or {}


def load_config(path: str) -> Config:
    """Load a reference-format YAML config."""
    data = load_yaml_stripped(path)
    precision = str(data.get("precision", "f32")).lower()
    if precision not in ("f32", "f64"):
        raise ValueError(f"precision must be f32 or f64, got {precision!r}")
    solver_data = data.get("solver")
    if isinstance(solver_data, dict) and "dynamic_flow_center" in solver_data:
        dfc = solver_data["dynamic_flow_center"]
        # YAML 1.1 reads bare on/off as booleans; map them back, then
        # validate (a typo must not pass as a mode).
        if isinstance(dfc, bool):
            dfc = "on" if dfc else "off"
        dfc = str(dfc).lower()
        if dfc not in ("auto", "on", "off"):
            raise ValueError(
                "solver.dynamic_flow_center must be one of auto/on/off, "
                f"got {solver_data['dynamic_flow_center']!r}")
        solver_data["dynamic_flow_center"] = dfc
    return Config(
        precision=precision,
        camera=_fill(CameraConfig, data.get("camera")),
        keyframe_management=_fill(KeyframeManagementConfig,
                                  data.get("keyframe_management")),
        feature_detection=_fill(FeatureDetectionConfig,
                                data.get("feature_detection")),
        optimization=_fill(OptimizationConfig, data.get("optimization")),
        tracker=_fill(TrackerConfig, data.get("tracker")),
        solver=_fill(SolverConfig, data.get("solver")),
        imu=_fill(ImuConfig, data.get("imu")),
    )


def make_estimator_config(cfg: Config, kind: str = "vo", device="cuda"):
    """Translate a Config into the port's (EstimatorConfig, CameraRig), the
    rig on `device` in float64 when ``precision: f64``. `kind` is the
    estimator the base config is for, "vo" or "vio": it resolves
    ``dynamic_flow_center: auto`` (on for VO, off for VIO, whose IMU anchors
    the pose)."""
    import torch

    from ..models import ba as ba_mod
    from ..models import estimator as est
    from ..models import pnp as pnp_mod
    from ..models.frontend import FrontendConfig
    from ..ops import cameras
    from ..ops.klt import KLTConfig

    if kind not in ("vo", "vio"):
        raise ValueError(f"kind must be 'vo' or 'vio', got {kind!r}")
    dtype = torch.float64 if cfg.precision == "f64" else torch.float32
    kind_l = cfg.camera.left_model or "pinhole-radtan"
    kind_r = cfg.camera.right_model or "pinhole-radtan"
    params_l = cameras.pack_params(kind_l, cfg.camera.left_intrinsics,
                                   cfg.camera.left_distortion, dtype=dtype,
                                   device=device)
    params_r = cameras.pack_params(kind_r, cfg.camera.right_intrinsics,
                                   cfg.camera.right_distortion, dtype=dtype,
                                   device=device)
    rig = est.make_rig(
        params_l, params_r,
        torch.tensor(cfg.camera.T_B_Cl_matrix(), dtype=dtype, device=device),
        torch.tensor(cfg.camera.T_B_Cr_matrix(), dtype=dtype, device=device))

    t, s = cfg.tracker, cfg.solver
    klt_cfg = KLTConfig(
        max_iterations=cfg.feature_detection.optical_flow_max_iterations,
        convergence_threshold=(
            cfg.feature_detection.optical_flow_convergence_threshold),
        levels=t.pyramid_levels,
        bidir_threshold_sq=t.bidir_threshold_sq,
        track_rotation=t.track_rotation,
        residual_mode=t.residual_mode,
        lm_lambda=t.lm_lambda,
        interpolation=t.interpolation,
        backend=t.backend,
        coarse_level_policy=t.coarse_level_policy,
    )
    fe_cfg = FrontendConfig(
        capacity=t.feature_capacity,
        cell_size=cfg.feature_detection.grid_size,
        detect_margin=t.detect_margin,
        min_score=t.min_corner_score,
        max_per_cell=cfg.feature_detection.max_features_per_grid,
        relax_floor_below=(t.feature_capacity // 2
                           if t.relax_floor_below < 0
                           else t.relax_floor_below),
        relaxed_min_score=t.relaxed_min_score,
        relax_max_per_cell=t.relax_max_per_cell,
        klt=klt_cfg,
        detect_mode=t.detect_mode,
        nms_radius=t.nms_radius,
        nms_max_new=t.nms_max_new,
        score_weight_floor=t.score_weight_floor,
        score_weight_power=t.score_weight_power,
        score_weight_ref=t.score_weight_ref,
    )
    ecfg = est.EstimatorConfig(
        frontend=fe_cfg,
        window_size=cfg.keyframe_management.keyframe_window_size,
        translation_threshold=cfg.keyframe_management.translation_threshold,
        rotation_threshold=cfg.keyframe_management.rotation_threshold,
        cam_kind_l=kind_l.lower() if kind_l.lower() == "eucm" else kind_l,
        cam_kind_r=kind_r.lower() if kind_r.lower() == "eucm" else kind_r,
        pnp=pnp_mod.PnPConfig(
            max_iterations=cfg.optimization.pnp_max_iterations,
            huber_delta=s.huber_delta,
            cost_tol=s.cost_tol, param_tol=s.param_tol,
            chi2_gate=s.chi2_gate,
            chi2_gate_iter=s.chi2_gate_iter,
            motion_prior_weight=s.pnp_motion_prior,
            ransac_hypotheses=s.ransac_hypotheses,
            ransac_threshold=s.ransac_threshold,
            ransac_min_inliers=s.ransac_min_inliers),
        ba=ba_mod.BAConfig(
            max_iterations=cfg.optimization.bundle_adjustment_max_iterations,
            huber_delta=s.huber_delta,
            cost_tol=s.cost_tol, param_tol=s.param_tol,
            chi2_gate=s.chi2_gate,
            chi2_gate_iter=s.chi2_gate_iter,
            min_lm_span=s.min_lm_span),
        image_shape=(cfg.camera.image_height, cfg.camera.image_width),
        cull_reproj_threshold=s.cull_reproj_threshold,
        use_marginalization=s.marginalization,
        track_before_full=cfg.keyframe_management.track_before_full,
        pnp_cv_predict=s.pnp_cv_predict,
        use_obs_weights=s.score_weighted_obs,
        pnp_ransac_kill=s.ransac_kill_outliers,
        pnp_prior_adaptive=s.pnp_prior_adaptive,
        vision_weight_adaptive=s.vision_weight_adaptive,
        health_floor=s.health_floor,
        health_f_lo=s.health_f_lo,
        health_f_hi=s.health_f_hi,
        health_recover=s.health_recover,
        dynamic_flow_thresh=s.dynamic_flow,
        dynamic_flow_decay=s.dynamic_flow_decay,
        dynamic_flow_min_n=s.dynamic_flow_min_n,
        # "auto" resolves per estimator kind (validated in load_config).
        dynamic_flow_center=(kind != "vio" if s.dynamic_flow_center == "auto"
                             else s.dynamic_flow_center == "on"),
    )
    return ecfg, rig


def make_imu_params(cfg: Config):
    """The imu: section as models.imu.ImuParams."""
    from ..models.imu import ImuParams

    return ImuParams(gyro_noise=cfg.imu.gyroscope_noise_density,
                     accel_noise=cfg.imu.accelerometer_noise_density,
                     gyro_bias_walk=cfg.imu.gyroscope_random_walk,
                     accel_bias_walk=cfg.imu.accelerometer_random_walk)
