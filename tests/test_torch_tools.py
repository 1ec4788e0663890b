"""The port's tools (rsvio_tpu_torch/tools/) against the JAX package's
(tools/*.py, examples/synthetic_vo.py), on the CPU at tiny sizes.

* accuracy_matrix: the same profiles and per-scene seeds as JAX's tool;
  its main writes the JSON keys and row keys of the committed
  accuracy_matrix.json (JAX's tool's output), one row per scene x config.
* synthetic_vo: its texture against the example's cv2.resize(INTER_CUBIC)
  within 1e-3 grey levels and a frame against cv2.remap within 5e-3
  (tests/test_torch_synthetic.py's tolerances); main passes on the CPU.
* bench_solvers: make_problem equal to JAX's (the same numpy draws;
  float32 arrays within 1e-6, masks equal); main times all four solvers.
* profile_components: main times every component.
* evaluate_ate / gnss_to_tum: the same printed numbers as JAX's CLIs on
  the same TUM, EuRoC-csv (ns stamps) and GNSSPoses files, with --scale
  and --gnss.
* bench_dist_scaling: world size 2 over gloo; the all-reduce bytes of an
  LM iteration equal at two landmark counts; the JSON keys of the
  committed dist_scaling.json.
* No module of the port, and not chip_smoke.py, imports jax, rsvio_tpu or
  cv2; every tool's device defaults to CUDA and raises without one.
"""

import contextlib
import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from rsvio_tpu_torch.tools import (accuracy_matrix, bench_dist_scaling,
                                   bench_solvers, evaluate_ate, gnss_to_tum,
                                   profile_components, synthetic_vo)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("accuracy_matrix", "synthetic_vo", "bench_solvers",
         "profile_components", "evaluate_ate", "gnss_to_tum",
         "bench_dist_scaling")


def _jax_script(rel):
    """Import one of the JAX package's scripts by path (they are not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def test_port_imports_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|rsvio_tpu|cv2)\b(?!_torch)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "rsvio_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
    assert any(f.endswith(os.path.join("tools", "accuracy_matrix.py"))
               for f in files)


@pytest.mark.parametrize("name", TOOLS)
def test_tool_defaults_to_cuda(name):
    """Each tool's device flag defaults to cuda; without a card that
    default raises instead of running on the CPU."""
    mod = {"accuracy_matrix": accuracy_matrix, "synthetic_vo": synthetic_vo,
           "bench_solvers": bench_solvers,
           "profile_components": profile_components,
           "bench_dist_scaling": bench_dist_scaling}.get(name)
    if mod is None:    # host-only file tools: no device at all
        src = open(os.path.join(ROOT, "rsvio_tpu_torch", "tools",
                                name + ".py")).read()
        assert "import torch" not in src and "--device" not in src
        return
    flag = "--devices" if name == "bench_dist_scaling" else "--device"
    src = open(mod.__file__).read()
    assert re.search(rf'"{flag}", default="cuda"', src)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


def test_accuracy_matrix_profiles_match_jax():
    jam = _jax_script("tools/accuracy_matrix.py")
    assert accuracy_matrix.CONFIGS == jam.CONFIGS
    # The per-scene rng of JAX's main: seed + crc32(scene).
    import zlib
    for s in ("depth_6dof", "occlusion_6dof"):
        np.testing.assert_array_equal(
            accuracy_matrix.scene_rng(7, s).normal(size=4),
            np.random.default_rng(7 + zlib.crc32(s.encode())).normal(size=4))
    # JAX's resolution-scaled geometry (its main, inline).
    for w in (752, 320, 188, 120):
        H, W, lv, cell, margin = accuracy_matrix.geometry(w)
        assert (H, lv, cell, margin) == (
            int(w * 480 / 752), max(3, min(6, int(round(np.log2(w / 12))))),
            max(16, int(round(50 * w / 752))),
            max(6, int(round(19 * w / 752))))


def test_accuracy_matrix_main_writes_jax_keys(tmp_path):
    out = tmp_path / "m.json"
    rc, text = _stdout(accuracy_matrix.main, [
        "--device", "cpu", "--frames", "8", "--width", "120", "--window",
        "4", "--capacity", "48", "--scenes", "easy_plane",
        "occlusion_6dof", "--configs", "vo_fifo", "vio_adapt", "--json",
        str(out)])
    assert rc == 0 and "| Scene | Config | ATE RMSE (m) |" in text
    got = json.loads(out.read_text())
    want = json.load(open(os.path.join(ROOT, "accuracy_matrix.json")))
    assert list(got) == list(want)
    assert got["device"] == "cpu"
    assert [list(r) for r in got["rows"]] == \
        [list(want["rows"][0])] * len(got["rows"])
    assert [(r["scene"], r["config"]) for r in got["rows"]] == [
        (s, c) for s in ("easy_plane", "occlusion_6dof")
        for c in ("vo_fifo", "vio_adapt")]
    for r in got["rows"]:
        assert np.isfinite(r["ate_rmse_m"]) and r["frames"] == 8


def test_synthetic_vo_texture_render_and_main():
    import cv2
    rng = np.random.default_rng(0)
    want = cv2.resize(rng.uniform(40, 220, (96, 96)).astype(np.float32),
                      (1536, 1536), interpolation=cv2.INTER_CUBIC)
    tex = synthetic_vo.make_texture(torch.device("cpu"))
    assert float(np.abs(tex.numpy() - want).max()) <= 1e-3
    cam = np.array([0.14, 0.0, 0.0])
    u, v = np.meshgrid(np.arange(synthetic_vo.W, dtype=np.float32),
                       np.arange(synthetic_vo.H, dtype=np.float32))
    mx = (((u - synthetic_vo.CX) / synthetic_vo.FX) * synthetic_vo.PLANE_Z
          + cam[0]) * synthetic_vo.TEX_SCALE + synthetic_vo.TEX_OFF
    my = (((v - synthetic_vo.CY) / synthetic_vo.FY) * synthetic_vo.PLANE_Z
          + cam[1]) * synthetic_vo.TEX_SCALE + synthetic_vo.TEX_OFF
    ref = cv2.remap(want, mx.astype(np.float32), my.astype(np.float32),
                    cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
    got = synthetic_vo.render(tex, cam).numpy()
    assert float(np.abs(got - ref).max()) <= 5e-3
    rc, text = _stdout(synthetic_vo.main, ["--device", "cpu", "--frames",
                                           "14"])
    assert rc == 0 and "RESULT: PASS" in text, text[-800:]


def test_bench_solvers_problem_equals_jax():
    import jax
    jbs = _jax_script("tools/bench_solvers.py")
    want = jax.tree_util.tree_leaves(jbs.make_problem(0))
    got = bench_solvers.make_problem(0, device="cpu")
    got = [x for part in got for x in (part if isinstance(part, tuple)
                                       else (part,))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-6)


def test_bench_solvers_and_profile_components_main(monkeypatch):
    res = bench_solvers.main(["--device", "cpu", "-n", "1", "--lm", "8",
                              "--window", "3"])
    assert list(res) == ["BA", "BA+marg", "VIO BA", "VIO BA+marg"]
    assert all(v > 0 for v in res.values())
    for k, v in dict(SHAPE=(64, 96), LEVELS=3, FEATURES=16,
                     WINDOW=3).items():
        monkeypatch.setattr(profile_components, k, v)
    res = profile_components.main(["--device", "cpu"])
    assert list(res) == ["dispatch", "pyramid", "fast_score",
                         "shi_tomasi_score", "klt_bidir_20",
                         "klt_bidir_20_launches", "klt_bidir_8",
                         "klt_bidir_8_launches", "pnp", "ba"]
    assert res["klt_bidir_20_launches"] == 0     # plain versions on the CPU


def _trajectories(tmp_path):
    rng = np.random.default_rng(5)
    n = 40
    t = 1.4e9 + np.arange(n) * 0.05
    gt = np.cumsum(rng.normal(size=(n, 3)) * 0.05, axis=0)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    est = 1.3 * gt @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]]).T + 0.4 \
        + rng.normal(size=(n, 3)) * 0.01
    paths = {}
    for name, ts, pos in (("est.tum", t + 0.003, est), ("gt.tum", t, gt)):
        with open(tmp_path / name, "w") as f:
            f.write("# t x y z qx qy qz qw\n")
            for a, p, b in zip(ts, pos, q):
                f.write(f"{a:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{b[0]} {b[1]} {b[2]} {b[3]}\n")
        paths[name] = str(tmp_path / name)
    with open(tmp_path / "gt.csv", "w") as f:      # EuRoC: ns, p, q(wxyz)
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for a, p in zip(t, gt):
            f.write(f"{int(round(a * 1e9))},{p[0]},{p[1]},{p[2]},1,0,0,0\n")
    paths["gt.csv"] = str(tmp_path / "gt.csv")
    with open(tmp_path / "GNSSPoses.txt", "w") as f:
        f.write("# ts, tx, ty, tz, qx, qy, qz, qw, scale\n")
        for a, p in zip(t, gt):
            f.write(f"{int(round(a * 1e9))}, {p[0] / 2}, {p[1] / 2}, "
                    f"{p[2] / 2}, 0, 0, 0, 1, 2.0\n")
    paths["gnss"] = str(tmp_path / "GNSSPoses.txt")
    return paths


def test_evaluate_ate_and_gnss_to_tum_print_jax_numbers(tmp_path):
    jate = _jax_script("tools/evaluate_ate.py")
    jgnss = _jax_script("tools/gnss_to_tum.py")
    p = _trajectories(tmp_path)
    cases = [[p["est.tum"], p["gt.tum"]],
             [p["est.tum"], p["gt.tum"], "--scale"],
             [p["est.tum"], p["gt.csv"], "--max-dt", "0.01"],
             [p["est.tum"], p["gnss"], "--gnss", "--scale"],
             [p["est.tum"], p["gt.tum"], "--max-dt", "0.001"]]   # too few
    for args in cases:
        want = _stdout(jate.main, args)
        got = _stdout(evaluate_ate.main, args)
        assert got == want, args
    assert "ate_rmse_m" in _stdout(evaluate_ate.main, cases[1])[1]
    assert _stdout(evaluate_ate.main, cases[-1])[0] == 1
    for tool, out in ((jgnss, "j.tum"), (gnss_to_tum, "t.tum")):
        rc, text = _stdout(tool.main, [p["gnss"], str(tmp_path / out)])
        assert rc == 0 and "wrote 40 poses" in text
    assert (tmp_path / "j.tum").read_text() == (tmp_path / "t.tum").read_text()
    assert _stdout(gnss_to_tum.main, [p["gnss"]])[0] == 2


def test_bench_dist_scaling_gloo_world_size_2(tmp_path, monkeypatch):
    out = tmp_path / "d.json"
    monkeypatch.setattr(bench_dist_scaling, "RANKS", (1, 2))
    res = bench_dist_scaling.main([
        "--devices", "cpu", "--per-device", "16", "--repeats", "1",
        "--iters", "4", "--window", "4", "--json", str(out)])
    want = json.load(open(os.path.join(ROOT, "dist_scaling.json")))
    got = json.loads(out.read_text())
    assert list(got) == list(want) and got == json.loads(json.dumps(res))
    assert [r["devices"] for r in got["weak_scaling"]] == [1, 2]
    for r in got["weak_scaling"]:
        assert set(want["weak_scaling"][0]) <= set(r)
        assert r["backend"] == "gloo" and r["iterations"] == 4
    comm = got["communication"]
    assert [c["landmarks"] for c in comm] == [32, 64]
    assert set(want["communication"][0]) <= set(comm[0])
    assert comm[0]["allreduce_bytes"] == comm[1]["allreduce_bytes"] > 0
    assert comm[0]["n_allreduce"] == comm[1]["n_allreduce"] == 3
    assert comm[0]["predicted_schur_psum_bytes"] == (16 * 36 + 24 + 1) * 4
