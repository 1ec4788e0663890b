"""Parity of the port's ops (rsvio_tpu_torch/ops) with the JAX package.

Every test builds its inputs with numpy from a fixed seed, runs the JAX
function (vmapped where the JAX function is per-element) and the port's
batched counterpart on the CPU, and compares.

Tolerances: 1e-5 absolute and relative unless stated — both sides are fp32
and differ only in the order of small sums and in fused multiply-adds, a few
ulps. ``fast_score``, the bench scene's integer geometry and grid selection
must agree exactly: they are the same comparisons, min/max and integer
arithmetic on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.ops import cameras as jcam
from rsvio_tpu.ops import detect as jdet
from rsvio_tpu.ops import lie as jlie
from rsvio_tpu.ops import projection as jproj
from rsvio_tpu.ops import pyramid as jpyr
from rsvio_tpu_torch.data import bench_scene
from rsvio_tpu_torch.ops import cameras as tcam
from rsvio_tpu_torch.ops import detect as tdet
from rsvio_tpu_torch.ops import lie as tlie
from rsvio_tpu_torch.ops import projection as tproj
from rsvio_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
EUROC_INTR = [458.654, 457.296, 367.215, 248.375]
EUROC_DIST = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]


def tt(x):
    """numpy or JAX array -> CPU tensor (a writable copy)."""
    return torch.from_numpy(np.array(x))


def close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def _angles(seed, n=24):
    """Axis-angle vectors: generic, tiny (Taylor branch) and exactly zero."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[: n // 3] *= 1e-5                      # theta^2 < 1e-8: Taylor branch
    w[n // 3] = 0.0
    w[n // 3 + 1:] *= 0.7                    # generic, below pi
    return w


def _poses(seed, n):
    rng = np.random.default_rng(seed)
    R = jax.vmap(jlie.so3_exp)(jnp.asarray(
        rng.normal(size=(n, 3)).astype(np.float32) * 0.3))
    t = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    return np.array(jax.vmap(jlie.se3_from_rt)(R, t))


class TestLie:
    def test_so3_exp_log_jacobian_near_zero_and_generic(self):
        w = _angles(0)
        wt = tt(w)
        close(tlie.so3_hat(wt), jax.vmap(jlie.so3_hat)(w))
        R_j = jax.vmap(jlie.so3_exp)(w)
        close(tlie.so3_exp(wt), R_j)
        close(tlie.so3_log(tt(R_j)),
              jax.vmap(jlie.so3_log)(R_j))
        close(tlie.so3_left_jacobian(wt), jax.vmap(jlie.so3_left_jacobian)(w))
        close(tlie.rotation_angle(tt(R_j)),
              jax.vmap(jlie.rotation_angle)(R_j), rtol=1e-4, atol=1e-3)

    def test_se3_exp_inverse_retract(self):
        rng = np.random.default_rng(1)
        xi = np.concatenate([rng.normal(size=(24, 3)).astype(np.float32),
                             _angles(2)], axis=1)
        close(tlie.se3_exp(tt(xi)), jax.vmap(jlie.se3_exp)(xi))
        T = _poses(3, 24)
        close(tlie.se3_inverse(tt(T)),
              jax.vmap(jlie.se3_inverse)(T))
        close(tlie.se3_retract_split(tt(T), tt(xi)),
              jax.vmap(jlie.se3_retract_split)(T, xi))


class TestCameras:
    def test_pack_params(self):
        close(tcam.pack_params(tcam.PINHOLE_RADTAN, EUROC_INTR, EUROC_DIST,
                               device="cpu"),
              jcam.pack_params(jcam.PINHOLE_RADTAN, EUROC_INTR, EUROC_DIST),
              rtol=0, atol=0)
        with pytest.raises(NotImplementedError):
            tcam.unproject("eucm", torch.zeros(10), torch.zeros(2))

    def test_radtan_project_unproject(self):
        rng = np.random.default_rng(4)
        p = np.stack([rng.uniform(-2, 2, 40), rng.uniform(-1.5, 1.5, 40),
                      rng.uniform(-1, 6, 40)], axis=1).astype(np.float32)
        pj = jcam.pack_params(jcam.PINHOLE_RADTAN, EUROC_INTR, EUROC_DIST)
        pt = tt(pj)
        uv_j, val_j = jax.vmap(lambda x: jcam.radtan_project(pj, x))(p)
        uv_t, val_t = tcam.radtan_project(pt, tt(p))
        np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
        close(uv_t, uv_j, rtol=1e-5, atol=1e-3)   # pixels: ~1e-5 relative
        uv = rng.uniform([0, 0], [752, 480], size=(40, 2)).astype(np.float32)
        close(tcam.unproject(tcam.PINHOLE_RADTAN, pt, tt(uv)),
              jax.vmap(lambda u: jcam.unproject(jcam.PINHOLE_RADTAN, pj, u))(uv))


class TestProjection:
    def test_linearize_projection(self):
        rng = np.random.default_rng(5)
        n = 32
        T_cb = _poses(6, n) * 0 + np.eye(4, dtype=np.float32)
        T_cb[:, 0, 3] = -0.11
        T_bw = _poses(7, n)
        T_bw[:, :3, 3] *= 0.2
        p_W = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                        rng.uniform(-2, 8, n)], axis=1).astype(np.float32)
        obs = rng.normal(size=(n, 2)).astype(np.float32) * 0.5
        mask = rng.uniform(size=n) > 0.2
        f = jax.vmap(lambda a, b, c, d, e: jproj.linearize_projection(
            a, b, c, d, e, 0.3))
        lj = f(T_cb, T_bw, p_W, obs, mask)
        lt = tproj.linearize_projection(*(tt(x) for x in
                                          (T_cb, T_bw, p_W, obs, mask)), 0.3)
        np.testing.assert_array_equal(lt.valid.numpy(), np.asarray(lj.valid))
        assert (~lt.valid).any() and lt.valid.any()
        for name in ("r", "J_pose", "J_lm", "cost"):
            close(getattr(lt, name), getattr(lj, name), rtol=1e-4, atol=1e-4)

    def test_triangulate_stereo(self):
        rng = np.random.default_rng(8)
        n = 32
        T_l = _poses(9, n)
        T_r = T_l.copy()
        T_r[:, :3, 3] += T_l[:, :3, 0] * 0.11       # right camera along x
        xy_l = rng.normal(size=(n, 2)).astype(np.float32) * 0.3
        xy_r = xy_l - np.float32(0.02) + rng.normal(size=(n, 2)).astype(
            np.float32) * 0.01
        xy_r[:4] = xy_l[:4] + 0.05                   # behind: invalid
        pj, vj = jax.vmap(jproj.triangulate_stereo)(T_l, T_r, xy_l, xy_r)
        pt, vt = tproj.triangulate_stereo(*(tt(x) for x in
                                            (T_l, T_r, xy_l, xy_r)))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        assert vt.any() and (~vt).any()
        # Depth from a 0.11 m baseline amplifies fp32 rounding of the ray
        # directions by ~depth/baseline (up to ~60x here): 1e-3 relative.
        close(pt[vt], np.asarray(pj)[vt.numpy()], rtol=1e-3, atol=1e-4)

    def test_huber(self):
        r_sq = np.linspace(0, 9, 50, dtype=np.float32)
        close(tproj.huber_weight(tt(r_sq), 2.0),
              jproj.huber_weight(r_sq, 2.0))
        close(tproj.huber_cost(tt(r_sq), 2.0),
              jproj.huber_cost(r_sq, 2.0))


@pytest.mark.parametrize("shape", [(37, 53), (64, 96), (101, 30)])
def test_build_pyramid_odd_sizes(shape):
    img = np.random.default_rng(10).uniform(0, 255, shape).astype(np.float32)
    pj = jpyr.build_pyramid(jnp.asarray(img), 4)
    pt = tpyr.build_pyramid(tt(img), 4)
    assert [tuple(x.shape) for x in pt] == [x.shape for x in pj] \
        == [tuple(s) for s in tpyr.pyramid_shapes(shape, 4)]
    for a, b in zip(pt, pj):
        close(a, b)


def _score_image(seed, H=72, W=100):
    """Blocky integer image: many exact FAST score ties and plateaus."""
    rng = np.random.default_rng(seed)
    img = np.kron(rng.integers(0, 6, (H // 4, W // 4)),
                  np.ones((4, 4))).astype(np.float32) * 40.0
    return img[:H, :W]


def test_fast_score_exact():
    img = _score_image(11)
    s_t = tdet.fast_score(tt(img))
    s_j = jdet.fast_score(jnp.asarray(img))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("margin,min_score,per_cell",
                         [(4, 10.0, 1), (13, 30.0, 1), (4, 10.0, 2)])
def test_select_grid_features_exact(margin, min_score, per_cell):
    """Exact candidates with score ties (first maximum wins), all -inf cells
    (margin 13 blanks whole border cells), occupied cells, and live tracks
    at negative or out-of-image positions (floor division then clip)."""
    img = _score_image(12)
    score = np.asarray(jdet.fast_score(jnp.asarray(img)))
    # Quantize so that many cells hold several maxima.
    score = np.floor(score / 40.0) * 40.0
    rng = np.random.default_rng(13)
    occ = rng.uniform([-30, -30], [130, 100], size=(20, 2)).astype(np.float32)
    occ_mask = rng.uniform(size=20) > 0.4
    xy_j, ok_j = jdet.select_grid_features(
        jnp.asarray(score), jnp.asarray(occ), jnp.asarray(occ_mask), 12,
        margin=margin, min_score=min_score, max_per_cell=per_cell)
    xy_t, ok_t = tdet.select_grid_features(
        tt(score), tt(occ),
        tt(occ_mask), 12, margin=margin, min_score=min_score,
        max_per_cell=per_cell)
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.any() and (~ok_t).any()


def test_select_grid_starvation_path_raises():
    with pytest.raises(NotImplementedError):
        tdet.select_grid_features(torch.zeros(48, 48), torch.zeros(1, 2),
                                  torch.zeros(1, dtype=torch.bool), 12,
                                  cell_occupancy=False)


def test_bench_scene_matches_opencv_render():
    """The OpenCV-free render agrees with cv2.resize(INTER_CUBIC) +
    cv2.remap(INTER_LINEAR, BORDER_REFLECT). OpenCV interpolates with
    fixed-point weights (1/32 px steps), so allow a few grey levels."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    octaves = ((90.0, 24), (60.0, 96))
    tex_cv = sum(w * cv2.resize(rng.uniform(0, 1, (n, n)).astype(np.float32),
                                (384, 384), interpolation=cv2.INTER_CUBIC)
                 for w, n in octaves) + 40.0
    tex = bench_scene.make_texture(0, size=384, octaves=octaves)
    np.testing.assert_allclose(tex.numpy(), tex_cv, atol=1e-3)
    kw = dict(shape=(60, 90), fx=60.0, plane_z=5.0, scale=30.0, offset=190.0)
    for cam_x in (0.0, 0.37, -7.0):     # -7 m puts the view over the border
        u, v = np.meshgrid(np.arange(90, dtype=np.float32),
                           np.arange(60, dtype=np.float32))
        mx = (((u - 45) / 60.0 * 5.0 + cam_x) * 30.0 + 190.0).astype(np.float32)
        my = (((v - 30) / 60.0 * 5.0) * 30.0 + 190.0).astype(np.float32)
        ref = cv2.remap(tex_cv, mx, my, cv2.INTER_LINEAR,
                        borderMode=cv2.BORDER_REFLECT)
        ours = bench_scene.render(tex, cam_x, **kw).numpy()
        assert np.abs(ours - ref).mean() < 0.2
        assert np.abs(ours - ref).max() < 3.0
