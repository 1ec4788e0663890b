"""The port's rerun viewer (rsvio_tpu_torch/viewers/rerun_viewer.py) against
the JAX package's (rsvio_tpu/viewers/rerun_viewer.py), both driven against
the same recording stand-in for the rerun SDK (the SDK is not installed
here): the recorder and stub of tests/test_rerun_viewer.py, copied, with one
named class per archetype so that the recorded calls carry the archetype.

Both viewers get the same calls on the same seeded inputs; the recorded
SDK calls must agree: method, entity path, archetype name, keyword names,
JPEG quality, and every array and number to 1e-6 (the quaternions come
from each package's own rot_to_quat_np). Also: the capability probe
(compatible; each capability missing alone; an incompatible SDK refusing
at start-up), the ~30 fps clock, the 300 m filter, the JPEG quality of
every image, degradation after the first failed call (logged once), the
Turbo colormap where the SDK has it, and ``create_viewer``'s fallback
without the SDK (one warning naming it).

``equalize_hist`` (the port's numpy histogram equalization) must equal
``cv2.equalizeHist`` exactly.

Then the command lines with the stub in ``sys.modules``: ``run_euroc
--viewer`` and ``run_tartanair --viewer`` on the CPU on small trees write
the trajectory of the same run without the viewer byte for byte, and log,
frame for frame, the entity paths JAX's command lines log on the same tree
(the JAX EuRoC CLI on its Pallas kernel route in interpret mode, as
tests/test_torch_cli.py runs it; its per-frame keyframe decisions equal the
port's there).
"""

import logging
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from rsvio_tpu.viewers import rerun_viewer as jrv
from rsvio_tpu_torch.data import writers
from rsvio_tpu_torch.viewers import base as tbase
from rsvio_tpu_torch.viewers import rerun_viewer as trv

torch.set_num_threads(2)

TOL = 1e-6
ARCHETYPES = ("Arrows3D", "Points2D", "Points3D", "Transform3D",
              "Quaternion", "Pinhole", "LineStrips3D", "DepthImage")


class _Recorder:
    def __init__(self):
        self.calls = []          # (method, args) tuples
        self.raise_on_log = False

    # --- module-level API the viewer touches ---
    def init(self, app_id, spawn=True):
        self.calls.append(("init", app_id, spawn))

    def log(self, path, obj, static=False):
        if self.raise_on_log:
            raise ConnectionError("viewer went away")
        self.calls.append(("log", path, obj))

    def set_time_sequence(self, name, value):
        self.calls.append(("set_time_sequence", name, value))

    def set_time_seconds(self, name, value):
        self.calls.append(("set_time_seconds", name, value))

    def logged_paths(self):
        return [c[1] for c in self.calls if c[0] == "log"]


class _Archetype:
    def __init__(self, *a, **k):
        self.args = a
        self.kwargs = k


def _make_stub(recorder, turbo=False):
    rr = types.ModuleType("rerun")
    rr.init = recorder.init
    rr.log = recorder.log
    rr.set_time_sequence = recorder.set_time_sequence
    rr.set_time_seconds = recorder.set_time_seconds

    class ViewCoordinates:
        RDF = "RDF"

    class Image(_Archetype):
        def __init__(self, data, **k):
            super().__init__(data, **k)
            self.data = data
            self.compressed = None

        def compress(self, jpeg_quality=75):
            self.compressed = jpeg_quality
            return self

    rr.ViewCoordinates = ViewCoordinates
    rr.Image = Image
    for name in ARCHETYPES:
        setattr(rr, name, type(name, (_Archetype,), {}))
    if turbo:
        rr.components = types.SimpleNamespace(
            Colormap=types.SimpleNamespace(Turbo="turbo"))
    return rr


def _norm(x):
    """A recorded value as plain data: archetypes as (name, args, kwargs,
    JPEG quality), tuples as lists."""
    if isinstance(x, _Archetype):
        return ["<" + type(x).__name__ + ">", _norm(list(x.args)),
                _norm(x.kwargs), getattr(x, "compressed", None)]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _assert_same(a, b, where="call"):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, where
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64), atol=TOL,
                                   rtol=0, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(float(a) - float(b)) <= TOL, where
    else:
        assert a == b, where


def _assert_same_calls(jrec, trec):
    assert len(jrec.calls) == len(trec.calls)
    for i, (a, b) in enumerate(zip(jrec.calls, trec.calls)):
        _assert_same(_norm(a), _norm(b), f"call {i} {a[:2]}")


def _pair(monkeypatch, turbo=False):
    """JAX's and the port's viewers, each initialized against its own
    recorder (the stub is in sys.modules while each initializes)."""
    out = []
    for mod in (jrv, trv):
        rec = _Recorder()
        monkeypatch.setitem(sys.modules, "rerun", _make_stub(rec, turbo))
        v = mod.RerunViewer(spawn=False)
        assert v.initialize()
        out.append((v, rec))
    return out


def _drive(v, seed=0):
    """Every viewer method once or more, on seeded inputs."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-20, 300, (24, 32))
    uv = rng.uniform(0, 30, (7, 2))
    ids = rng.integers(0, 10_000, 7)
    pts = rng.normal(size=(9, 3)) * 5
    pts[2] = [0, 0, 400.0]
    pts[5] = [250.0, 200.0, 0.0]
    ang = rng.normal(size=3) * 0.4
    K = np.array([[0, -ang[2], ang[1]], [ang[2], 0, -ang[0]],
                  [-ang[1], ang[0], 0]])
    th = np.linalg.norm(ang)
    R = (np.eye(3) + np.sin(th) / th * K
         + (1 - np.cos(th)) / th ** 2 * K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3)
    v.set_frame(5, 123)
    v.log_image_with_features_colored("stereo/left", img, uv, ids)
    v.log_image_with_features("stereo/right", img[::-1], uv, None)
    v.log_image_raw("raw", img)
    v.log_image_equalized("equalized", img)
    v.log_pose("pose_current", T)
    v.log_points_colored("map/points", pts, ids.tolist() + [1, 2])
    v.log_points("map/plain", pts)
    v.log_camera_frustum("pose_0", T, [400.0, 410.0, 16.0, 12.0, 0.1],
                         (32, 24))
    v.log_trajectory("trajectory/path", pts[:4])
    v.log_labeled_points("ft/labels", uv, [str(i) for i in ids])
    v.log_pyramid("ft/pyramid", [img, img[::2, ::2], img[::4, ::4]])
    v.log_float_map("ft/score", rng.normal(size=(12, 16)))
    v.set_frame(6)


@pytest.mark.parametrize("turbo", (False, True), ids=("no_cmap", "turbo"))
def test_calls_match_jax(monkeypatch, turbo):
    (jv, jrec), (tv, trec) = _pair(monkeypatch, turbo)
    _drive(jv)
    _drive(tv)
    _assert_same_calls(jrec, trec)
    assert trec.calls[0] == ("init", "rsvio_tpu", False)
    assert trec.logged_paths()[:2] == ["/", "origin"]
    dm = [c[2] for c in trec.calls if c[0] == "log" and c[1] == "ft/score"]
    assert dm[0].kwargs == ({"colormap": "turbo"} if turbo else {})


def test_clock_and_jpeg_quality(monkeypatch):
    (_, _), (tv, trec) = _pair(monkeypatch)
    _drive(tv)
    assert ("set_time_sequence", "frame", 5) in trec.calls
    secs = [c[2] for c in trec.calls if c[0] == "set_time_seconds"]
    assert secs == [5 * 0.0333, 6 * 0.0333]
    images = [c[2] for c in trec.calls if c[0] == "log"
              and type(c[2]).__name__ == "Image"]
    assert len(images) == 7
    assert all(o.compressed == 75 and o.data.dtype == np.uint8
               for o in images)
    raw = [c[2] for c in trec.calls if c[0] == "log" and c[1] == "raw"][0]
    assert raw.data.min() == 0 and raw.data.max() == 255
    orders = [c[2].kwargs["draw_order"] for c in trec.calls
              if c[0] == "log" and c[1].startswith("ft/pyramid/level_")]
    assert orders == [0.0, 1.0, 2.0]


def test_point_distance_filter(monkeypatch):
    (_, _), (tv, trec) = _pair(monkeypatch)
    pts = np.array([[0, 0, 5.0], [0, 0, 400.0], [299.0, 0, 0],
                    [300.0, 0, 0]])
    tv.log_points_colored("map/points", pts, [1, 2, 3, 4])
    obj = trec.calls[-1][2]
    np.testing.assert_array_equal(obj.args[0], pts[[0, 2]])
    assert obj.kwargs["colors"] == [tbase.get_feature_color(1),
                                    tbase.get_feature_color(3)]
    assert obj.kwargs["radii"] == 0.02


def test_labeled_points_at_pixel_centres(monkeypatch):
    (_, _), (tv, trec) = _pair(monkeypatch)
    tv.log_labeled_points("ft/pts", np.array([[3.0, 7.0]]), [42])
    obj = trec.calls[-1][2]
    np.testing.assert_array_equal(obj.args[0], [[3.5, 7.5]])
    assert obj.args[0].dtype == np.float32
    assert obj.kwargs["labels"] == ["42"]


@pytest.mark.parametrize("method", ("log_pose", "log_trajectory",
                                    "log_image_raw", "set_frame"))
def test_connection_loss_degrades_once(monkeypatch, caplog, method):
    """The first failing call logs one warning and turns each viewer into
    a no-op; both packages alike."""
    args = {"log_pose": ("pose_current", np.eye(4)),
            "log_trajectory": ("trajectory/path", np.zeros((2, 3))),
            "log_image_raw": ("stereo/left", np.zeros((4, 4))),
            "set_frame": (3,)}[method]
    counts = []
    for v, rec in _pair(monkeypatch):
        rec.raise_on_log = True
        if method == "set_frame":
            def boom(*a):
                raise ConnectionError("viewer went away")
            v._rr.set_time_sequence = boom
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            getattr(v, method)(*args)
            rec.raise_on_log = False
            n = len(rec.calls)
            _drive(v)
        counts.append(sum("connection lost" in r.getMessage()
                          for r in caplog.records))
        assert len(rec.calls) == n
        assert not v._initialized
    assert counts == [1, 1]


CAPABILITIES = ("ViewCoordinates", "Arrows3D", "set_time_sequence",
                "set_time_seconds", "Transform3D", "Quaternion", "Image",
                "Points2D", "Points3D", "Pinhole", "LineStrips3D",
                "DepthImage")


@pytest.mark.parametrize("missing", (None,) + CAPABILITIES)
def test_probe_matches_jax(missing):
    """The same 13 checks: none fails on the stub; with one SDK name gone,
    both packages' probes name the same failing checks."""
    out = []
    for mod in (jrv, trv):
        rr = _make_stub(_Recorder())
        if missing:
            delattr(rr, missing)
        out.append([m.split(":")[0] for m in mod.probe_capabilities(rr)])
    assert out[0] == out[1]
    if missing is None:
        assert out[1] == []
    else:
        assert out[1] and all(missing in m for m in out[1])


def test_incompatible_sdk_disables_viewer(monkeypatch, caplog):
    rec = _Recorder()
    rr = _make_stub(rec)

    class BadPoints3D:  # signature drift: rejects the radii keyword
        def __init__(self, pts, colors=None):
            pass

    rr.Points3D = BadPoints3D
    monkeypatch.setitem(sys.modules, "rerun", rr)
    v = trv.RerunViewer(spawn=False)
    with caplog.at_level(logging.WARNING):
        assert not v.initialize()
    assert any("Points3D" in r.getMessage() for r in caplog.records)
    assert rec.calls == []
    _drive(v)
    assert rec.calls == []


def test_create_viewer_falls_back_without_sdk(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "rerun", None)
    with caplog.at_level(logging.WARNING, logger="rsvio"):
        v = tbase.create_viewer(True)
    assert type(v) is tbase.NullViewer
    assert sum("rerun SDK" in r.getMessage() for r in caplog.records) == 1
    v.initialize()
    v.log_pose("pose_current", np.eye(4))
    # Not asked for: no warning; with the SDK: the rerun viewer.
    caplog.clear()
    assert type(tbase.create_viewer(False)) is tbase.NullViewer
    assert not caplog.records
    rec = _Recorder()
    monkeypatch.setitem(sys.modules, "rerun", _make_stub(rec))
    v = tbase.create_viewer(True)
    assert isinstance(v, trv.RerunViewer)
    assert rec.calls[0] == ("init", "rsvio_tpu", True)


def _eq_images():
    rng = np.random.default_rng(3)
    two = np.where(rng.random((31, 17)) < 0.3, 40, 200).astype(np.uint8)
    return {
        "random": rng.integers(0, 256, (48, 64)).astype(np.uint8),
        "narrow": rng.integers(90, 110, (33, 29)).astype(np.uint8),
        "two_level": two,
        "constant": np.full((9, 11), 77, np.uint8),
        "constant_zero": np.zeros((5, 5), np.uint8),
        "one_pixel": np.array([[200]], np.uint8),
        "full_range": np.arange(256, dtype=np.uint8).reshape(16, 16),
        "skewed": (rng.random((40, 40)) ** 4 * 255).astype(np.uint8),
    }


@pytest.mark.parametrize("name", sorted(_eq_images()))
def test_equalize_hist_equals_cv2(name):
    cv2 = pytest.importorskip("cv2")
    img = _eq_images()[name]
    out = trv.equalize_hist(img)
    assert out.dtype == np.uint8 and out.shape == img.shape
    np.testing.assert_array_equal(out, cv2.equalizeHist(img))


# ------------------------------------------------------------ command lines

H, W, N = 96, 128, 4
T0 = 1_403_636_579_763_555_584
CONFIG = f"""%YAML:1.0
---
camera:
  image_width: {W}
  image_height: {H}
  left_intrinsics: [100.0, 100.0, {W / 2}, {H / 2}]
  left_distortion: [0.0, 0.0, 0.0, 0.0]
  right_intrinsics: [100.0, 100.0, {W / 2}, {H / 2}]
  right_distortion: [0.0, 0.0, 0.0, 0.0]
  T_B_Cl: [1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1]
  T_B_Cr: [1,0,0,0.11, 0,1,0,0, 0,0,1,0, 0,0,0,1]
keyframe_management:
  keyframe_window_size: 3
  translation_threshold: 0.01
  rotation_threshold: 0.05
feature_detection:
  grid_size: 24
  max_features_per_grid: 1
  optical_flow_max_iterations: 10
  optical_flow_convergence_threshold: 0.01
optimization:
  pnp_max_iterations: 5
  bundle_adjustment_max_iterations: 5
tracker:
  pyramid_levels: 3
  feature_capacity: 32
  detect_margin: 10
  min_corner_score: 5.0
  backend: pallas
"""


def _texture(h, w, seed=0):
    rng = np.random.default_rng(seed)
    small = torch.from_numpy(
        rng.uniform(0, 255, (h // 6, w // 6)).astype(np.float32))
    up = torch.nn.functional.interpolate(small[None, None], size=(h, w),
                                         mode="bicubic", align_corners=False)
    return up[0, 0].round().clamp(0, 255).to(torch.uint8).numpy()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A stereo EuRoC tree (a texture shifting (k, 2k) px a frame, the
    right view 6 px further) with its config, and a TartanAir tree."""
    root = str(tmp_path_factory.mktemp("viewer_trees"))
    base = _texture(2 * H, 2 * W)
    frames = [(np.ascontiguousarray(base[k:k + H, 2 * k:2 * k + W]),
               np.ascontiguousarray(base[k:k + H, 2 * k + 6:2 * k + 6 + W]))
              for k in range(N)]
    euroc = os.path.join(root, "euroc")
    writers.write_euroc(euroc, frames, [T0 + 50_000_000 * k
                                        for k in range(N)])
    cfg = os.path.join(root, "config.yaml")
    with open(cfg, "w") as f:
        f.write(CONFIG)
    tartan = writers.write_tartanair(os.path.join(root, "tartan"),
                                     [a for a, _ in frames])
    return euroc, cfg, tartan, root


def _per_frame_paths(rec):
    """The entity paths logged after each set_frame, in order, with the
    keyframe index of pose_<i> kept."""
    frames = []
    for c in rec.calls:
        if c[0] == "set_time_sequence":
            frames.append([])
        elif c[0] == "log" and frames:
            frames[-1].append(c[1])
    return frames


def _run_with_stub(monkeypatch, main, argv):
    rec = _Recorder()
    monkeypatch.setitem(sys.modules, "rerun", _make_stub(rec))
    assert main(argv) in (0, None)
    return rec


def test_run_euroc_viewer_matches_plain_run_and_jax_schema(trees,
                                                          monkeypatch):
    from rsvio_tpu.cli import run_euroc as jrun_euroc
    from rsvio_tpu_torch.cli import run_euroc as trun_euroc
    euroc, cfg, _, root = trees
    out = {k: os.path.join(root, f"traj_{k}.txt")
           for k in ("plain", "viewer", "jax")}
    trun_euroc.main([cfg, euroc, "--device", "cpu", "--quiet",
                     "--trajectory-out", out["plain"]])
    trec = _run_with_stub(monkeypatch, trun_euroc.main, [
        cfg, euroc, "--device", "cpu", "--quiet", "--viewer",
        "--trajectory-out", out["viewer"]])
    with open(out["plain"], "rb") as a, open(out["viewer"], "rb") as b:
        assert a.read() == b.read()
    jrec = _run_with_stub(monkeypatch, jrun_euroc.main, [
        cfg, euroc, "--viewer", "--trajectory-out", out["jax"]])
    tpaths, jpaths = _per_frame_paths(trec), _per_frame_paths(jrec)
    assert len(tpaths) == N and tpaths == jpaths
    for k, paths in enumerate(tpaths):
        kinds = {re.sub(r"^pose_\d+$", "pose_<i>", p) for p in paths}
        want = {"stereo/left", "stereo/left/features", "stereo/right",
                "stereo/right/features", "pose_current", "pose_<i>"}
        assert want <= kinds, (k, kinds)
        assert ("trajectory/path" in kinds) == (k > 0)
        assert kinds <= want | {"trajectory/path", "map/points"}
    assert any("map/points" in p for p in tpaths)
    assert trec.calls[0] == ("init", "rsvio_tpu", True)


def test_run_tartanair_viewer_matches_plain_run_and_jax_schema(
        trees, monkeypatch):
    from rsvio_tpu.cli import run_tartanair as jrun_tartanair
    from rsvio_tpu_torch.cli import run_tartanair as trun_tartanair
    _, _, tartan, _ = trees
    argv = [tartan, "--levels", "3", "--capacity", "32", "--quiet"]
    trun_tartanair.main(argv + ["--device", "cpu"])
    plain = trun_tartanair.main.last_result
    trec = _run_with_stub(monkeypatch, trun_tartanair.main,
                          argv + ["--device", "cpu", "--viewer"])
    shown = trun_tartanair.main.last_result
    assert (shown.tracked, shown.alive) == (plain.tracked, plain.alive)
    jrec = _run_with_stub(monkeypatch, jrun_tartanair.main,
                          argv + ["--viewer"])
    tpaths, jpaths = _per_frame_paths(trec), _per_frame_paths(jrec)
    assert len(tpaths) == N and tpaths == jpaths
    assert tpaths[0] == ["tartanair/left", "tartanair/left/features",
                         "tartanair/labels", "tartanair/pyramid/level_0",
                         "tartanair/pyramid/level_1",
                         "tartanair/pyramid/level_2", "tartanair/shi_tomasi"]
    # The debug surface's payloads: labels at pixel centres, the pyramid
    # as JPEG images with draw order, the corner scores as a float map.
    logs = [c for c in trec.calls if c[0] == "log"]
    lab = [o for _, p, o in logs if p == "tartanair/labels"][-1]
    pts = [o for _, p, o in logs if p == "tartanair/left/features"][-1]
    np.testing.assert_allclose(lab.args[0], np.asarray(pts.args[0]) + 0.5,
                               atol=1e-5)
    sc = [o for _, p, o in logs if p == "tartanair/shi_tomasi"][-1]
    assert sc.args[0].dtype == np.float32 and sc.args[0].shape == (H, W)
