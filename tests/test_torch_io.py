"""The port's data path and helpers against the JAX package and OpenCV.

Held here, on seeded inputs (numpy generators):
  * ``data.png``: ``read_gray`` equal to ``cv2.imread(..., IMREAD_GRAYSCALE)``
    on files written by ``cv2.imwrite`` (8- and 16-bit gray, RGB and RGBA at
    8 and 16 bits) and by ``write_png`` with each row filter (gray, 16-bit
    gray, RGB, gray+alpha, which cv2 cannot write), on random images and on
    the 752x480 bench frame. Gray is held exactly; colour within 1 grey
    level (the conversion cv2 documents as approximate; measured gap 0).
    The C++ unfilter equals the numpy one; palette, interlaced, 4-bit,
    truncated and corrupted files raise.
  * ``data.players``: manifests, IMU, ``frame_paths``, ground-truth paths
    and decoded frames equal to the JAX players' on the same trees (EuRoC
    with comment, header and junk rows; 4Seasons; TartanAir);
    ``prefetch_frames`` keeps order and raises a decode error at its frame.
  * ``utils.trajectory``, ``utils.observer``: equal results and bytes.
  * ``utils.checkpoint``: a file written by JAX's ``save_state`` loads leaf
    for leaf; the port's file round-trips; a mismatched config raises.
  * ``cli.playback``: the scripted key sequences of tests/test_playback.py
    give the same trace in both packages.
  * ``viewers.artifacts``: overlay, colormap and pyramid PNGs pixel-equal to
    the JAX viewer's files; PLY, SVG, trajectory, labels and poses files
    byte-equal; a failed write raises.
"""

import os
import struct
import zlib

import cv2
import jax
import numpy as np
import pytest
import torch

from rsvio_tpu.cli import playback as jplay
from rsvio_tpu.data import players as jplayers
from rsvio_tpu.models import estimator as jest
from rsvio_tpu.utils import checkpoint as jckpt
from rsvio_tpu.utils import config as jconfig
from rsvio_tpu.utils import observer as jobs
from rsvio_tpu.utils import trajectory as jtraj
from rsvio_tpu.viewers import artifacts as jart
from rsvio_tpu_torch.cli import playback as tplay
from rsvio_tpu_torch.data import bench_scene, png
from rsvio_tpu_torch.data import players as tplayers
from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.utils import checkpoint as tckpt
from rsvio_tpu_torch.utils import config as tconfig
from rsvio_tpu_torch.utils import observer as tobs
from rsvio_tpu_torch.utils import trajectory as ttraj
from rsvio_tpu_torch.viewers import artifacts as tart

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config")


@pytest.fixture(scope="module")
def bench_frame():
    """The 752x480 bench frame, quantized to uint8."""
    tex = bench_scene.make_texture(0)
    img = bench_scene.render(tex, 0.0)
    return img.round().clamp(0, 255).to(torch.uint8).numpy()


def _random(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)


def _cv2_gray(path):
    return cv2.imread(path, cv2.IMREAD_GRAYSCALE)


# --------------------------------------------------------------- png reader

CV2_KINDS = {           # name -> (shape suffix, dtype, exact)
    "gray8": ((), np.uint8, True), "gray16": ((), np.uint16, True),
    "rgb8": ((3,), np.uint8, False), "rgb16": ((3,), np.uint16, False),
    "rgba8": ((4,), np.uint8, False), "rgba16": ((4,), np.uint16, False)}


def _check_gray(path, exact):
    got = png.read_gray(path)
    want = _cv2_gray(path).astype(np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert float(np.abs(got - want).max()) <= 1.0


@pytest.mark.parametrize("kind", list(CV2_KINDS))
@pytest.mark.parametrize("image", ["random", "bench"])
def test_read_gray_equals_cv2_on_cv2_files(tmp_path, kind, image,
                                           bench_frame):
    suffix, dtype, exact = CV2_KINDS[kind]
    if image == "random":
        img = _random((37, 53) + suffix, dtype, seed=len(kind))
    else:
        base = bench_frame.astype(dtype)
        if dtype == np.uint16:   # high byte = the frame, low byte = noise
            base = base * 256 + _random(base.shape, np.uint8, 1)
        img = np.stack([np.roll(base, 7 * c, axis=1) for c in
                        range(suffix[0])], axis=2) if suffix else base
        if suffix == (4,):
            img[..., 3] = 200
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img)
    _check_gray(path, exact)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "cycle"])
@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8", "gray_alpha8",
                                  "gray_alpha16", "bench"])
def test_read_gray_equals_cv2_on_written_files(tmp_path, filters, kind,
                                               bench_frame):
    if kind == "bench":
        img = bench_frame
    else:
        suffix = {"gray8": (), "gray16": (), "rgb8": (3,),
                  "gray_alpha8": (2,), "gray_alpha16": (2,)}[kind]
        img = _random((29, 41) + suffix,
                      np.uint16 if kind.endswith("16") else np.uint8, 5)
    f = png.cycle_filters(img.shape[0]) if filters == "cycle" else filters
    path = str(tmp_path / "w.png")
    png.write_png(path, img, filters=f)
    np.testing.assert_array_equal(png.read_png(path), img)
    _check_gray(path, exact=kind != "rgb8")


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_cpp_unfilter_equals_numpy(bpp):
    rng = np.random.default_rng(bpp)
    h, row_bytes = 23, 7 * bpp
    raw = rng.integers(0, 256, (h, row_bytes + 1), dtype=np.uint8)
    raw[:, 0] = rng.integers(0, 5, h)
    raw[:5, 0] = [0, 1, 2, 3, 4]
    data = raw.tobytes()
    np.testing.assert_array_equal(png.unfilter(data, h, row_bytes, bpp),
                                  png.unfilter_numpy(data, h, row_bytes, bpp))
    bad = bytearray(data)
    bad[3 * (row_bytes + 1)] = 7
    for fn in (png.unfilter, png.unfilter_numpy):
        with pytest.raises(ValueError, match="filter type 7"):
            fn(bytes(bad), h, row_bytes, bpp)


def _png_bytes(ihdr_fields, extra=b"", raw=None):
    w, h, depth, ctype, il = ihdr_fields
    raw = raw if raw is not None else b"\x00" * (h * (w + 1))
    return (png.SIGNATURE + png._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, il)) + extra
        + png._chunk(b"IDAT", zlib.compress(raw)) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("case,match", [
    ("palette", "color_type=3"), ("interlaced", "interlace=1"),
    ("depth4", "bit_depth=4"), ("truncated", "truncated"),
    ("crc", "CRC mismatch"), ("short_data", "truncated image data")])
def test_unsupported_and_broken_files_raise(tmp_path, case, match):
    path = str(tmp_path / "x.png")
    good = str(tmp_path / "g.png")
    png.write_png(good, _random((8, 9), np.uint8, 0))
    data = {
        "palette": lambda: _png_bytes((9, 8, 8, 3, 0), png._chunk(
            b"PLTE", bytes(range(12)))),
        "interlaced": lambda: _png_bytes((9, 8, 8, 0, 1)),
        "depth4": lambda: _png_bytes((9, 8, 4, 0, 0)),
        "truncated": lambda: open(good, "rb").read()[:-20],
        "crc": lambda: open(good, "rb").read()[:-1] + b"\x00",
        "short_data": lambda: _png_bytes((9, 8, 8, 0, 0),
                                         raw=b"\x00" * 40),
    }[case]()
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=match):
        png.read_gray(path)


# ------------------------------------------------------------------ players

def _euroc_tree(root, n=5, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    cam0, cam1 = root / "mav0" / "cam0", root / "mav0" / "cam1"
    for d in (cam0 / "data", cam1 / "data", root / "mav0" / "imu0",
              root / "mav0" / "state_groundtruth_estimate0"):
        d.mkdir(parents=True)
    stamps = [1_403_636_579_763_555_584 + 50_000_000 * k for k in range(n)]
    for k, ts in enumerate(stamps):
        for cam in (cam0, cam1):
            png.write_png(str(cam / "data" / f"{ts}.png"),
                          rng.integers(0, 256, (h, w), dtype=np.uint8),
                          filters=png.cycle_filters(h, k))
    rows = ["#timestamp [ns],filename", "timestamp,filename", ""]
    rows += [f"{ts},{ts}.png" for ts in reversed(stamps)] + ["junk,x.png"]
    (cam0 / "data.csv").write_text("\n".join(rows) + "\n")
    imu = ["#timestamp,wx,wy,wz,ax,ay,az"] + [
        f"{stamps[0] + 5_000_000 * k}," + ",".join(
            f"{v:.6f}" for v in rng.normal(size=6)) for k in range(12)]
    (root / "mav0" / "imu0" / "data.csv").write_text("\n".join(imu) + "\n")
    (root / "mav0" / "state_groundtruth_estimate0" / "data.csv").write_text(
        "#t,x,y,z,qw,qx,qy,qz\n")
    return str(root)


def _four_seasons_tree(root, n=4, h=20, w=28):
    rng = np.random.default_rng(3)
    for cam in ("cam0", "cam1"):
        (root / "undistorted_images" / cam).mkdir(parents=True)
    stamps = [1_600_000_000_000_000_000 + 100_000_000 * k for k in range(n)]
    lines = ["# frame timestamps"]
    for ts in reversed(stamps):
        lines.append(f"{ts} {ts * 1e-9:.6f} 0.01")
        for cam in ("cam0", "cam1"):
            png.write_png(str(root / "undistorted_images" / cam /
                              f"{ts}.png"),
                          rng.integers(0, 256, (h, w), dtype=np.uint8))
    (root / "times.txt").write_text("\n".join(lines) + "\n")
    (root / "GNSSPoses.txt").write_text("# gnss\n")
    return str(root)


def _tartanair_tree(root, n=3, h=20, w=28):
    rng = np.random.default_rng(4)
    (root / "image_left").mkdir(parents=True)
    for k in reversed(range(n)):
        png.write_png(str(root / "image_left" / f"{k:06d}_left.png"),
                      rng.integers(0, 256, (h, w), dtype=np.uint8))
    (root / "image_left" / "notes.txt").write_text("x")
    return str(root)


@pytest.mark.parametrize("layout", ["euroc", "tum", "4seasons", "tartanair"])
def test_players_equal_jax(tmp_path, layout):
    make = {"euroc": _euroc_tree, "tum": _euroc_tree,
            "4seasons": _four_seasons_tree, "tartanair": _tartanair_tree}
    root = make[layout](tmp_path / layout)
    cls = {"euroc": "EurocPlayer", "tum": "TUMVIPlayer",
           "4seasons": "FourSeasonsPlayer", "tartanair": "TartanAirPlayer"}
    pj = getattr(jplayers, cls[layout])(root)
    pt = getattr(tplayers, cls[layout])(root)
    assert pt.entries == pj.entries and len(pt) == len(pj) > 2
    for i in range(len(pj)):
        if hasattr(pj, "frame_paths"):
            assert pt.frame_paths(i) == pj.frame_paths(i)
        fj, ft = pj.load_frame(i), pt.load_frame(i)
        assert ft.timestamp_ns == fj.timestamp_ns
        for a, b in ((ft.left, fj.left), (ft.right, fj.right)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    if hasattr(pj, "load_imu"):
        ij, it = pj.load_imu(), pt.load_imu()
        assert [s.timestamp_ns for s in it] == [s.timestamp_ns for s in ij]
        for a, b in zip(it, ij):
            np.testing.assert_array_equal(a.gyro, b.gyro)
            np.testing.assert_array_equal(a.accel, b.accel)
        assert pt.ground_truth_file() == pj.ground_truth_file()


@pytest.mark.parametrize("depth", [1, 4])
def test_prefetch_order_and_decode_error(tmp_path, depth):
    root = _euroc_tree(tmp_path / "e", n=6)
    p = tplayers.EurocPlayer(root)
    ms = []
    frames = list(tplayers.prefetch_frames(p, 1, 5, depth=depth,
                                           decode_ms=ms))
    assert [f.timestamp_ns for f in frames] == [e[0] for e in p.entries[1:5]]
    assert len(ms) == 4 and min(ms) > 0
    for i, f in zip(range(1, 5), frames):
        ref = p.load_frame(i)
        assert f.left.dtype == np.uint8 and f.tensors[0].dtype == torch.uint8
        np.testing.assert_array_equal(f.left.astype(np.float32), ref.left)
        np.testing.assert_array_equal(f.tensors[0].numpy(), f.left)
        np.testing.assert_array_equal(f.tensors[1].numpy(), f.right)
    # Corrupt frame 3's right image: frames 0-2 arrive, then the error.
    with open(p.frame_paths(3)[2], "r+b") as fh:
        fh.seek(40)
        fh.write(b"\xff\xff\xff\xff")
    got = []
    with pytest.raises(ValueError, match="CRC|corrupt|truncated"):
        for f in tplayers.prefetch_frames(p, 0, None, depth=depth):
            got.append(f.timestamp_ns)
    assert got == [e[0] for e in p.entries[:3]]


# --------------------------------------------------------- trajectory utils

def _poses(rng, n):
    out = []
    for k in range(n):
        a = rng.normal(size=3) * (0.3 if k % 4 else 3.0)
        R = cv2.Rodrigues(a)[0]
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, rng.normal(size=3)
        out.append(T)
    return out


def test_trajectory_equals_jax(tmp_path):
    rng = np.random.default_rng(7)
    poses = _poses(rng, 24)
    for R in ([np.diag([1.0, -1, -1])], [np.diag([-1.0, 1, -1])],
              [np.diag([-1.0, -1, 1])]):
        poses.append(np.eye(4))
        poses[-1][:3, :3] = R[0]
    for T in poses:      # every branch of the quaternion extraction
        np.testing.assert_array_equal(ttraj.rot_to_quat_np(T[:3, :3]),
                                      jtraj.rot_to_quat_np(T[:3, :3]))
    ts = [1_000_000_000 + 50_000_000 * k for k in range(len(poses))]
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jtraj.save_tum(pj, ts, poses)
    ttraj.save_tum(pt, ts, poses)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for a, b in zip(ttraj.load_tum(pj), jtraj.load_tum(pj)):
        np.testing.assert_array_equal(a, b)
    ta = np.sort(rng.uniform(0, 10, 40))
    tb = np.sort(ta[::2] + rng.uniform(-0.03, 0.03, 20))
    for a, b in zip(ttraj.associate(ta, tb), jtraj.associate(ta, tb)):
        np.testing.assert_array_equal(a, b)
    x = rng.normal(size=(30, 3))
    y = 1.7 * x @ cv2.Rodrigues(np.array([0.2, -0.4, 0.9]))[0].T + 0.3 \
        + rng.normal(size=(30, 3)) * 0.01
    for scale in (False, True):
        for a, b in zip(ttraj.umeyama_alignment(x, y, scale),
                        jtraj.umeyama_alignment(x, y, scale)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ttraj.ate_rmse(x, y, scale),
                        jtraj.ate_rmse(x, y, scale)):
            np.testing.assert_array_equal(a, b)
    gnss = tmp_path / "GNSSPoses.txt"
    gnss.write_text("# ts, tx, ty, tz, qx, qy, qz, qw, scale\n" + "\n".join(
        f"{t},{p[0]},{p[1]},{p[2]},0,0,0,1" + (",2.0,1" if i % 2 else "")
        for i, (t, p) in enumerate(zip(ts, rng.normal(size=(len(ts), 3))))))
    for a, b in zip(ttraj.load_gnss_poses(str(gnss)),
                    jtraj.load_gnss_poses(str(gnss))):
        np.testing.assert_array_equal(a, b)
    gj, gt = str(tmp_path / "gj.txt"), str(tmp_path / "gt.txt")
    assert ttraj.gnss_to_tum(str(gnss), gt) == jtraj.gnss_to_tum(str(gnss), gj)
    assert open(gt, "rb").read() == open(gj, "rb").read()
    assert ttraj.evaluate_ate(pt, gt) == jtraj.evaluate_ate(pj, gj)


@pytest.mark.parametrize("cols,iters", [(6, None), (6, 3), (4, None)])
def test_format_metrics_equals_jax(cols, iters):
    m = np.random.default_rng(cols).normal(size=(5, cols))
    m[:, -1] = [1, 0, 1, 1, 0]
    assert tobs.format_metrics(m, iters) == jobs.format_metrics(m, iters)


# --------------------------------------------------------------- checkpoint

def _configs(name, **solver):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.load_config(os.path.join(CONFIG_DIR, name))
        for k, v in solver.items():
            setattr(cfg.solver, k, v)
        kw = {} if mod is jconfig else {"device": "cpu"}
        out.append(mod.make_estimator_config(cfg, kind="vo", **kw)[0])
    return out


def _filled_jax_state(cfg, seed):
    rng = np.random.default_rng(seed)

    def fill(leaf):
        a = np.asarray(leaf)
        if a.dtype == bool:
            return rng.integers(0, 2, a.shape).astype(bool)
        if a.dtype.kind in "iu":
            return rng.integers(-5, 1000, a.shape).astype(a.dtype)
        return rng.normal(size=a.shape).astype(a.dtype)

    return jax.tree.map(fill, jest.init_state(cfg))


@pytest.mark.parametrize("name,solver", [
    ("euroc_vio.yaml", {}),
    ("euroc_vo_adaptive.yaml", {"dynamic_flow": 0.02})])
def test_checkpoint_from_jax_and_round_trip(tmp_path, name, solver):
    jcfg, tcfg = _configs(name, **solver)
    sj = _filled_jax_state(jcfg, seed=len(name))
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_state(path, sj)
    template = test_.init_state(tcfg, device="cpu")
    st = tckpt.load_state(path, template)
    leaves_j = jax.tree.leaves(sj)
    leaves_t = tckpt.flatten(st)
    assert len(leaves_t) == len(leaves_j) == len(tckpt.flatten(template))
    for (n, t), j in zip(leaves_t, leaves_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=n)
    assert st.table.fid.dtype == torch.int32
    assert st.obs_mask.dtype == torch.bool
    # The port's own file round-trips, field names included.
    own = str(tmp_path / "port.ckpt")
    tckpt.save_state(own, st)
    back = tckpt.load_state(own, template)
    for (n, a), (_, b) in zip(tckpt.flatten(back), leaves_t):
        assert torch.equal(a, b), n
    assert not os.path.exists(own + ".tmp")
    # A template of another configuration refuses both files.
    other = test_.init_state(_configs("tum_vi.yaml")[1], device="cpu")
    for p in (path, own):
        with pytest.raises(ValueError, match="config mismatch"):
            tckpt.load_state(p, other)


# ----------------------------------------------------------------- playback

PLAYBACK_CASES = {      # (step_mode, keys replayed, then None forever)
    "no_step_mode": (False, []),
    "step_waits_for_enter": (True, [None, None, "\n"]),
    "quit": (True, ["q"]),
    "autoplay_toggle": (True, ["a"]),
    "autoplay_back_to_stepping": (True, ["a", "a", "\n", "q"]),
    "quit_during_autoplay": (True, ["a", "q"]),
    "eof_while_stepping": (True, ["<eof>"]),
    "eof_while_autoplay": (True, ["a", "<eof>"]),
}


def _trace(mod, step_mode, keys, n=6):
    it = iter(keys)
    polls = []

    def source(timeout):
        polls.append(timeout)
        return next(it, None)

    pc = mod.PlaybackController(step_mode, key_source=source, poll_s=0.0)
    out = []
    for _ in range(n):
        if len(polls) > 50:      # stepping with no key left: stop polling
            break
        out.append((pc.wait_for_advance(), pc.auto_play, pc.quit))
        if pc.quit:
            break
    return out, polls


@pytest.mark.parametrize("case", list(PLAYBACK_CASES))
def test_playback_controller_equals_jax(case):
    step_mode, keys = PLAYBACK_CASES[case]
    if step_mode and not any(k in ("a", "q", "<eof>") for k in keys):
        keys = keys + ["q"]      # end a stepping script
    assert tplay.EOF_KEY == jplay.EOF_KEY
    got = _trace(tplay, step_mode, keys)
    want = _trace(jplay, step_mode, keys)
    assert got == want and got[0]


# ----------------------------------------------------------- artifact viewer

def _viewer_inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-20, 280, (40, 56)).astype(np.float32)
    pts = np.concatenate([rng.uniform(-4, 60, (30, 2)),
                          [[0.5, 0.5], [2.5, 39.5], [55.4, 1.6]]])
    ids = rng.integers(0, 10_000, len(pts))
    lm = np.concatenate([rng.normal(size=(20, 3)) * 5, [[400.0, 0, 0]]])
    return img, pts, ids, lm, rng


def _drive_viewer(v, seed=0):
    img, pts, ids, lm, rng = _viewer_inputs(seed)
    for k in (0, 10):
        v.set_frame(k, 1000 + k)
        v.log_image_with_features_colored("stereo/left", img, pts, ids)
        v.log_image_raw("raw", img)
        v.log_image_equalized("eq", img)
        v.log_pyramid("pyr", [img, img[::2, ::2], img[::4, ::4]])
        v.log_float_map("score", rng.normal(size=(20, 30)) ** 3)
        v.log_points_colored("map/points", lm, np.arange(len(lm)))
        v.log_labeled_points("labels", pts[:5], [str(i) for i in ids[:5]])
        v.log_pose("pose_current", np.eye(4) * (k + 1))
        v.log_camera_frustum("pose_0", np.eye(4), [1, 2, 3, 4], (56, 40))
        v.log_trajectory("trajectory/path", rng.normal(size=(k + 2, 3)))
    v.set_frame(11, 2000)


def test_artifact_viewer_files_equal_jax(tmp_path):
    dj, dt = tmp_path / "j", tmp_path / "t"
    _drive_viewer(jart.ArtifactViewer(str(dj)))
    _drive_viewer(tart.ArtifactViewer(str(dt)))
    fj = sorted(os.listdir(dj / "frames"))
    assert fj == sorted(os.listdir(dt / "frames")) and len(fj) == 14
    for name in fj:
        a = cv2.imread(str(dj / "frames" / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(dt / "frames" / name), cv2.IMREAD_UNCHANGED)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    others = sorted(set(os.listdir(dj)) - {"frames"})
    assert others == sorted(set(os.listdir(dt)) - {"frames"})
    assert {"map_points.ply", "trajectory.svg", "trajectory.txt",
            "poses.json", "labels_labels.txt"} <= set(others)
    for name in others:
        assert (dj / name).read_bytes() == (dt / name).read_bytes(), name


def test_disc_equals_cv2_circle():
    rng = np.random.default_rng(2)
    a = np.zeros((30, 40, 3), np.uint8)
    b = a.copy()
    for x, y in rng.integers(-5, 45, (60, 2)):
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        cv2.circle(a, (int(x), int(y)), 3, color, -1)
        tart.draw_disc(b, int(x), int(y), color)
    np.testing.assert_array_equal(a, b)
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_TURBO)[:, 0, ::-1]
    np.testing.assert_array_equal(tart.TURBO_RGB, lut)


def test_artifact_viewer_raises_on_failed_write(tmp_path):
    v = tart.ArtifactViewer(str(tmp_path / "v"))
    os.rmdir(tmp_path / "v" / "frames")
    (tmp_path / "v" / "frames").write_text("not a directory")
    img, pts, ids, _, _ = _viewer_inputs()
    v.set_frame(0, 0)
    with pytest.raises(OSError):
        v.log_image_with_features_colored("stereo/left", img, pts, ids)
