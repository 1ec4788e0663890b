"""The benchmark's own tests, on the CPU: its arithmetic, its traffic, its
discovery of files by name, its imports and its refusal without a card.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import readers, reference, run, scene, spec

ROOT = spec.ROOT
PKG = spec.HERE


# --- metric arithmetic -----------------------------------------------------

def test_latency_counts_every_due_frame_late_and_undone():
    due = [0.0, 0.05, 0.10, 0.15]
    done = [0.02, 0.12]           # frame 2 and 3 never done in the window
    lat = run.latencies_ms(due, done, t_end=0.2)
    assert lat == pytest.approx([20.0, 70.0, 100.0, 50.0])
    # the p95 is taken over all four frames, the undone ones included
    assert np.percentile(lat, 95) == pytest.approx(np.percentile(
        [20.0, 70.0, 100.0, 50.0], 95))


def test_latency_of_a_frame_done_after_the_window_is_its_age_then():
    lat = run.latencies_ms([0.0, 0.05], [0.04, 0.31], t_end=0.1)
    assert lat == pytest.approx([40.0, 50.0])


def test_rate_is_all_frames_done_in_the_window_over_its_seconds():
    done = [0.5, 1.0, 1.5, 2.5, 9.0, 10.2]
    assert run.frames_per_s(done, 0.0, 10.0) == pytest.approx(0.5)


def test_span_readers_split_keyframes():
    class R:
        spans = [(0.0, 0.010, False), (0.0, 0.012, False),
                 (0.0, 0.050, True)]
    assert readers.other_frame_ms(R) == pytest.approx(11.0)
    assert readers.kf_frame_ms(R) == pytest.approx(50.0)
    assert readers.keyframe_pct(R) == pytest.approx(100.0 / 3)


def test_trace_readers_return_nothing_without_a_trace():
    class R:
        trace = None
        slice_frames = []
        spans = []
    for f in (readers.device_idle_pct, readers.kernels_per_frame,
              readers.klt_roofline_pct, readers.keyframe_pct):
        assert f(R) is None


# --- traffic ---------------------------------------------------------------

def small_rig():
    conf = spec.config("euroc_vo")
    rig = scene.rig_from_config(conf["config"])
    s = 0.25
    params = tuple(np.concatenate([p[:4] * s, p[4:]]) for p in rig.params)
    return scene.Rig((120, 188), params, rig.T_B_C)


def test_loop_closes_and_repeats():
    for name in ("batch", "live"):
        loop = scene.loop_from_traffic(spec.traffic(name))
        rig = small_rig()
        T = loop.poses(np.array([0.0, loop.seconds, 2 * loop.seconds]), rig)
        assert np.allclose(T[0], T[1], atol=1e-9)
        assert np.allclose(T[0], T[2], atol=1e-9)
        v = loop.velocity(np.array([0.0, loop.seconds]))
        assert np.allclose(v[0], v[1], atol=1e-7)


def test_loop_speed_and_sway():
    t = np.arange(0, 12, 0.01)
    fast = scene.loop_from_traffic(spec.traffic("batch"))
    assert 0.6 < np.linalg.norm(fast.velocity(t), axis=1).max() < 0.8
    assert np.abs(fast.position(t)).max() == pytest.approx(0.9, rel=1e-3)


def test_stream_offsets():
    assert [scene.start_frame(i, 5, 240) for i in range(5)] == \
        [0, 48, 96, 144, 192]
    assert scene.start_frame(0, 1, 240) == 0


def render_loop(seed, frames=3):
    rig = small_rig()
    loop = scene.loop_from_traffic(spec.traffic("batch"))
    plane = scene.make_plane(loop, rig, 5.0)
    rnd = scene.Renderer(rig, plane, "cpu")
    tex = scene.make_texture(seed, "cpu", size=512,
                             octaves=((90.0, 24), (60.0, 96)))
    T = loop.poses(np.arange(frames) / loop.fps, rig)
    return [tuple(scene.to_uint8(x) for x in rnd.render(tex, T[j]))
            for j in range(frames)]


def test_same_seed_same_frames_other_seed_other_frames():
    a, b, c = render_loop(7), render_loop(7), render_loop(8)
    for (l1, r1), (l2, r2) in zip(a, b):
        assert torch.equal(l1, l2) and torch.equal(r1, r2)
    assert not torch.equal(a[0][0], c[0][0])
    assert a[0][0].dtype == torch.uint8


def make_imu(seed):
    conf = spec.config("euroc_vio")
    loop = scene.loop_from_traffic(spec.traffic("batch"))
    rig = scene.rig_from_config(conf["config"])
    rng = np.random.default_rng([seed, 0])
    imu = scene.make_imu(loop, rig, conf["imu"], rng, 0.0, 0.5)
    return loop, rig, imu, scene.frame_imu_buffers(imu, loop, 64)


def test_same_seed_same_imu_and_the_buffers_repeat_every_loop():
    loop, rig, a, ba = make_imu(11)
    _, _, b, bb = make_imu(11)
    _, _, c, _ = make_imu(12)
    assert np.array_equal(a.gyro, b.gyro) and np.array_equal(a.accel, b.accel)
    assert not np.array_equal(a.gyro, c.gyro)
    for x, y in zip(ba, bb):
        assert np.array_equal(x, y)
    g, acc, dts, mask = ba
    assert mask.sum(axis=1).tolist() == [10] * loop.frames
    # frame 0 holds the previous loop's last ten samples
    assert np.array_equal(g[0, :10], a.gyro[-10:])
    assert np.array_equal(g[1, :10], a.gyro[:10])
    assert np.allclose(dts[mask], 1.0 / 200)
    assert len(a.head_gyro) == 100


def test_imu_agrees_with_the_trajectory():
    """Noise-free samples preintegrated over a second give the loop's own
    change of pose and velocity (the reference's preintegration), within
    the few mm/s that holding each 5 ms sample's rate and force costs; a
    wrong sign or frame reads metres."""
    conf = spec.config("euroc_vio")
    loop = scene.loop_from_traffic(spec.traffic("batch"))
    rig = scene.rig_from_config(conf["config"])
    quiet = dict(conf["imu"], gyroscope_noise_density=0.0,
                 accelerometer_noise_density=0.0,
                 gyro_bias=[0, 0, 0], accel_bias=[0, 0, 0])
    imu = scene.make_imu(loop, rig, quiet, np.random.default_rng(0), 0.0,
                         0.5)
    n = 200
    dR, dv, dp = reference.preintegrate(imu.gyro[:n], imu.accel[:n],
                                        np.full(n, 1 / 200.0), np.zeros(3),
                                        np.zeros(3))
    T = loop.poses(np.array([0.0, 1.0]), rig)
    v = loop.velocity(np.array([0.0, 1.0]))
    R0 = T[0, :3, :3]
    g = scene.GRAVITY_W
    assert reference.rot_angle(dR.T @ (R0.T @ T[1, :3, :3])) < 2e-4
    assert np.linalg.norm(R0 @ dv + g * 1.0 - (v[1] - v[0])) < 5e-3
    assert np.linalg.norm(R0 @ dp + v[0] + 0.5 * g
                          - (T[1, :3, 3] - T[0, :3, 3])) < 5e-3


# --- discovery by name -----------------------------------------------------

def test_new_files_are_found_by_name_with_no_edit(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(PKG, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    conf = json.loads((base / "configs" / "euroc_vo.json").read_text())
    conf["name"] = "another_rig"
    (base / "configs" / "another_rig.json").write_text(json.dumps(conf))
    tr = json.loads((base / "traffic" / "batch.json").read_text())
    tr["streams"] = 3
    (base / "traffic" / "three.json").write_text(json.dumps(tr))
    (base / "limits" / "another_rig.three.json").write_text(
        json.dumps({"limits": {"motion_mm": 1.0}}))
    (base / "metrics" / "frames_seen.batch.py").write_text(
        "def read(run):\n    return float(len(run.spans))\n")
    assert spec.config("another_rig", str(base))["name"] == "another_rig"
    assert spec.traffic("three", str(base))["streams"] == 3
    assert spec.limits("another_rig.three", str(base))["limits"] == \
        {"motion_mm": 1.0}

    class R:
        spans = [1, 2, 3]
    assert spec.metric_reader("frames_seen.batch", str(base))(R) == 3.0
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": "another_rig.three",
                               "config": "another_rig", "traffic": "three",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_seen.batch", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "frames_per_s",
                               "workloads": ["another_rig.three"]})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("another_rig.three")
    e2e = [m["name"] for m in spec.metrics_for(bench, "another_rig.three",
                                               False)]
    assert e2e == ["frames_per_s", "setup_s"]
    pl = [m["name"] for m in spec.metrics_for(bench, "another_rig.three",
                                              True)]
    assert pl == ["frames_seen.batch"]


def test_every_cell_and_metric_has_its_files():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        spec.config(w["config"])
        spec.traffic(w["traffic"])
        assert "limits" in spec.limits(w["name"])
        assert spec.metrics_for(bench, w["name"], False)
        assert spec.metrics_for(bench, w["name"], True)
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


# --- imports ---------------------------------------------------------------

def imported_top_names(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def benchmark_sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in benchmark_sources():
        found = imported_top_names(path) & {"jax", "jaxlib", "flax",
                                            "rsvio_tpu"}
        assert not found, f"{path} imports {found}"


def test_the_reference_takes_nothing_from_the_program():
    for name in ("reference.py", "scene.py", "checks.py", "roofline.py"):
        path = os.path.join(PKG, name)
        assert "rsvio_tpu_torch" not in imported_top_names(path), path
        text = open(path).read()
        for word in ("rsvio_tpu_torch", "klt_bidir_reference",
                     "klt_level_reference", "_reference(", "conftest"):
            assert word not in text, (path, word)
    code = ("import sys; import portbench.reference, portbench.checks, "
            "portbench.scene; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'rsvio_tpu', 'rsvio_tpu_torch'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rsvio_tpu_torch_fake", object())
    assert "rsvio_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rsvio_tpu.something", object())
    assert run.forbidden_modules() == ["rsvio_tpu"]


# --- refusal ---------------------------------------------------------------

def run_command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "euroc_vo.batch", "--seed", "4000000001", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_the_command_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = run_command(ROOT, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_the_command_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run_command(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
