"""The port's fused-vs-composed tracker A/B
(rsvio_tpu_torch/tools/bench_tracker_fusion.py, the port of
tools/bench_tracker_fusion.py) on the CPU at a small size: 96x128, 3
levels, 32 points, chains of 2 passes.

* The composed route (``ops.klt.track_points`` forward and backward with
  the bidirectional gate; the plain klt_level_reference at each level on
  the CPU) against the JAX package's composition of its
  ``ops.klt.track_points`` on the Pallas route (interpret mode on the CPU,
  as tests/test_torch_tracker.py runs it), on the same numpy images (the
  tool's): ok equal, positions within 1e-3 px where ok (the K2 parity
  tolerance of tests/test_torch_tracker.py).
* The fused route (one klt_bidir call; its plain version here) against the
  composed one: the same survivors, positions within 1e-3 px.
* ``main(["--device", "cpu", ...])`` prints a line for each route and the
  survivors.
* The tool's images: the Gaussian and the shift against OpenCV's
  GaussianBlur (reflect-101) and warpAffine (reflect) on the same base, to
  OpenCV's 1/32 px quantization of the shift.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvio_tpu.ops import klt as jklt
from rsvio_tpu.ops import pyramid as jpyr
from rsvio_tpu_torch.tools import bench_tracker_fusion as bf

torch.set_num_threads(2)

POS_TOL = 1e-3
SMALL = dict(H=96, W=128, N=32, LEVELS=3)


@pytest.fixture
def small(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(bf, k, v)


def _jax_composed(img0, img1, pts, levels):
    """The JAX tool's composed(): track_points forward, backward from the
    result with the transposed warp, the bidirectional gate."""
    cfg = jklt.KLTConfig(levels=levels, backend="pallas")
    p0 = jpyr.build_pyramid(jnp.asarray(img0), levels)
    p1 = jpyr.build_pyramid(jnp.asarray(img1), levels)
    pts = jnp.asarray(pts)
    n = pts.shape[0]
    alive = jnp.ones(n, dtype=bool)
    eye = jnp.broadcast_to(jnp.eye(2, dtype=pts.dtype), (n, 2, 2))
    pos_fwd, A_fwd, ok_fwd = jklt.track_points(p0, p1, pts, pts, eye, alive,
                                               cfg)
    pos_back, _, ok_back = jklt.track_points(
        p1, p0, pos_fwd, pts, jnp.swapaxes(A_fwd, -1, -2), ok_fwd, cfg)
    dist_sq = jnp.sum((pos_back - pts) ** 2, axis=1)
    ok = ok_fwd & ok_back & (dist_sq < cfg.bidir_threshold_sq)
    return np.asarray(pos_fwd), np.asarray(ok)


def test_composed_route_matches_jax(small):
    img0, img1, pts0 = bf.make_inputs(torch.device("cpu"))
    pj, okj = _jax_composed(img0.numpy(), img1.numpy(), pts0.numpy(),
                            bf.LEVELS)
    p0, p1, pts, alive, cfg = bf.setup(torch.device("cpu"))
    np.testing.assert_array_equal(pts.numpy(), pts0.numpy())
    pt, okt = bf.composed(p0, p1, pts, alive, cfg)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert okj.sum() >= 0.9 * bf.N
    np.testing.assert_allclose(pt.numpy()[okj], pj[okj], atol=POS_TOL,
                               rtol=0)


def test_fused_matches_composed(small):
    p0, p1, pts, alive, cfg = bf.setup(torch.device("cpu"))
    pf, okf = bf.chain(bf.fused, p0, p1, pts, alive, cfg, 2)
    pc, okc = bf.chain(bf.composed, p0, p1, pts, alive, cfg, 2)
    np.testing.assert_array_equal(okf.numpy(), okc.numpy())
    ok = okf.numpy()
    np.testing.assert_allclose(pf.numpy()[ok], pc.numpy()[ok], atol=POS_TOL,
                               rtol=0)
    # The shift the second frame carries, recovered.
    d = (pf - pts).numpy()[ok]
    np.testing.assert_allclose(np.median(d, axis=0), bf.SHIFT, atol=0.05)


def test_main_prints_both_routes(small, capsys):
    assert bf.main(["--device", "cpu", "--chain", "2", "--epochs", "1"]) == 0
    out = capsys.readouterr().out
    lines = {ln.split(":")[0].strip(): ln for ln in out.splitlines()}
    for route in ("fused", "composed"):
        assert "ms/pass" in lines[route] and "host syncs/pass 0 []" in \
            lines[route]
    surv = [ln for ln in out.splitlines() if ln.startswith("survivors")]
    assert surv and "fused=" in surv[0] and "composed=" in surv[0]


def test_images_follow_opencv():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    base = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    blur = bf.gaussian_5x5(torch.from_numpy(base)).numpy()
    np.testing.assert_allclose(blur, cv2.GaussianBlur(base, (5, 5), 1.0),
                               atol=1e-3)
    # OpenCV samples at 1/32 px: compare at a shift on that grid.
    dx, dy = 1.3125, -0.90625
    M = np.float32([[1, 0, dx], [0, 1, dy]])
    want = cv2.warpAffine(base, M, (56, 40), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REFLECT)
    got = bf.shift_bilinear(torch.from_numpy(base), dx, dy).numpy()
    np.testing.assert_allclose(got, want, atol=1e-2)
