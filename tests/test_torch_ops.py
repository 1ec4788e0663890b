"""Parity of the port's ops (rsvio_tpu_torch/ops) with the JAX package.

Every test builds its inputs with numpy from a fixed seed, runs the JAX
function (vmapped where the JAX function is per-element) and the port's
batched counterpart on the CPU, and compares.

Tolerances: 1e-5 absolute and relative unless stated — both sides are fp32
and differ only in the order of small sums and in fused multiply-adds, a few
ulps. ``fast_score``, the bench scene's integer geometry and grid selection
(both occupancy forms) must agree exactly: they are the same comparisons,
min/max and integer arithmetic on both sides. EUCM project / unproject, on
a grid that reaches past the model's 90-degree ray: float64 within 1e-6
relative, float32 within 1e-5 relative (pixels 1e-3), validity equal.
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
from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.ops import lie as tlie
from rsvio_tpu_torch.ops import projection as tproj
from rsvio_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
EUROC_INTR = [458.654, 457.296, 367.215, 248.375]
EUROC_DIST = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
TUM_INTR = [191.75556798912652, 191.74816751185256, 254.9226487139376,
            256.8780365577954]
TUM_DIST = [0.6246288732884442, 1.0598071085569876]


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
        close(tcam.pack_params("EUCM", TUM_INTR, TUM_DIST, device="cpu"),
              jcam.pack_params("EUCM", TUM_INTR, TUM_DIST), rtol=0, atol=0)
        # EUCM defaults: alpha 0.5, beta 1.0.
        close(tcam.pack_params("eucm", TUM_INTR, [], device="cpu"),
              jcam.pack_params("eucm", TUM_INTR, []), rtol=0, atol=0)

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


def _eucm_points(n=400, seed=0):
    """Rays from 0 to 130 degrees off the optical axis at every azimuth,
    at ranges 0.5-20, plus the origin's neighbourhood."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.0, np.radians(130.0), n)
    ph = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(0.5, 20.0, n)
    p = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)], axis=1) * r[:, None]
    p[:4] = [[0.0, 0.0, 1.0], [1e-3, 0.0, 0.0], [0.0, 0.0, -1.0],
             [1.0, 1.0, 0.0]]
    return p


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_eucm_project_unproject_match_jax(dtype):
    np_dt = np.float32 if dtype == "f32" else np.float64
    with jax.enable_x64(dtype == "f64"):
        pj = jcam.pack_params(jcam.EUCM, TUM_INTR, TUM_DIST, dtype=np_dt)
        p = _eucm_points().astype(np_dt)
        uv_j, val_j = jax.vmap(lambda x: jcam.project(jcam.EUCM, pj, x))(p)
        # Every pixel of the 512x512 image and beyond: its corners lie past
        # the 90-degree ray (mz < 0).
        g = np.arange(-8.0, 521.0, 7.0, dtype=np_dt)
        uv = np.stack(np.meshgrid(g, g), axis=-1).reshape(-1, 2)
        xy_j = jax.vmap(lambda u: jcam.unproject(jcam.EUCM, pj, u))(uv)
        uv_j, val_j, xy_j = (np.asarray(a) for a in (uv_j, val_j, xy_j))
    pt = tcam.pack_params("EUCM", TUM_INTR, TUM_DIST, device="cpu", dtype=(
        torch.float32 if dtype == "f32" else torch.float64))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    uv_t, val_t = tcam.project("EUCM", pt, tt(p))
    np.testing.assert_array_equal(val_t.numpy(), val_j)
    assert val_t.any() and (~val_t).any()
    xy_t = tcam.unproject("eucm", pt, tt(uv))
    if dtype == "f64":
        np.testing.assert_allclose(uv_t.numpy(), uv_j, rtol=1e-6, atol=0)
        np.testing.assert_allclose(xy_t.numpy(), xy_j, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(uv_t.numpy(), uv_j, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(xy_t.numpy(), xy_j, rtol=1e-5, atol=1e-5)
    # Round trip inside the 90-degree ring (~300 px from the centre):
    # unproject inverts project.
    front = np.hypot(uv[:, 0] - TUM_INTR[2], uv[:, 1] - TUM_INTR[3]) < 250.0
    back, ok = tcam.project("eucm", pt, torch.cat(
        [xy_t, torch.ones_like(xy_t[:, :1])], dim=1))
    assert bool(ok[torch.from_numpy(front)].all())
    np.testing.assert_allclose(back.numpy()[front], uv[front],
                               atol=1e-2 if dtype == "f32" else 1e-8)


def test_unknown_camera_model_raises():
    with pytest.raises(ValueError, match="camera model"):
        tcam.unproject("kannala-brandt", torch.zeros(10), torch.zeros(2))
    with pytest.raises(ValueError, match="camera model"):
        test_.make_estimator_step(test_.EstimatorConfig(cam_kind_r="ds"))


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


@pytest.mark.parametrize("margin,min_score,per_cell,min_dist",
                         [(4, 1.0, 3, 5), (4, 40.0, 1, 5), (13, 1.0, 3, 3),
                          (4, 30.0, 2, 8)])
def test_select_grid_starvation_path_exact(margin, min_score, per_cell,
                                              min_dist):
    """Live tracks suppress a box around their rounded position (half-way
    positions round to even on both sides; tracks off the image clamp to
    its edge); several spaced picks per cell."""
    img = _score_image(12)
    score = np.floor(np.asarray(jdet.fast_score(jnp.asarray(img))) / 40.0) \
        * 40.0
    rng = np.random.default_rng(14)
    occ = rng.uniform([-30, -30], [130, 100], size=(24, 2)).astype(np.float32)
    occ[:4] = [[10.5, 20.5], [11.5, 21.5], [99.4, 71.6], [50.0, 36.0]]
    occ_mask = rng.uniform(size=24) > 0.3
    occ_mask[:4] = True
    xy_j, ok_j = jdet.select_grid_features(
        jnp.asarray(score), jnp.asarray(occ), jnp.asarray(occ_mask), 12,
        margin=margin, min_score=min_score, max_per_cell=per_cell,
        min_dist=min_dist, cell_occupancy=False)
    xy_t, ok_t = tdet.select_grid_features(
        tt(score), tt(occ), tt(occ_mask), 12, margin=margin,
        min_score=min_score, max_per_cell=per_cell, min_dist=min_dist,
        cell_occupancy=False)
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.any() and (~ok_t).any()


def test_render_rig_matches_render_on_the_bench_rig():
    """Through the bench's own pinhole rig (identity extrinsics, 0.11 m
    baseline) render_rig is the plane of stereo_frames: the same texture
    coordinates up to float32 rounding of the ray arithmetic."""
    tex = bench_scene.make_texture(0, size=384, octaves=((90.0, 24),
                                                         (60.0, 96)))
    shape, fx, scale, offset = (48, 64), 60.0, 30.0, 190.0
    rig = bench_scene.make_rig("cpu", shape=shape, fx=fx)
    kinds = (tcam.PINHOLE_RADTAN, tcam.PINHOLE_RADTAN)
    for k in (0, 3, 17):
        want = bench_scene.stereo_frames(
            tex, k + 1, shape=shape, fx=fx, scale=scale, offset=offset)[k]
        got = bench_scene.render_rig(tex, rig, kinds, k, shape, scale=scale,
                                     offset=offset,
                                     fade=(np.radians(80), np.radians(85)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-2)
        np.testing.assert_allclose(
            bench_scene.truth_position(rig, k).numpy(),
            [bench_scene.STEP_M * k, 0.0, 0.0], atol=1e-7)


def test_render_rig_moves_along_the_left_camera_x_axis():
    """With a rotated rig the truth is k step_m along the left camera's x
    axis in the body frame, and a point of the plane seen at frame 0 by the
    left camera moves by the truth in camera coordinates: the pixel where
    it appears shifts by fx * step / depth per frame."""
    tex = bench_scene.make_texture(0, size=384, octaves=((90.0, 24),
                                                         (60.0, 96)))
    R = tlie.so3_exp(torch.tensor([0.3, -0.2, 1.1]))
    T_l = torch.eye(4)
    T_l[:3, :3] = R
    T_r = T_l.clone()
    T_r[:3, 3] = 0.11 * R[:, 0]
    p = tcam.pack_params(tcam.PINHOLE_RADTAN, [60.0, 60.0, 32.0, 24.0], [],
                         device="cpu")
    rig = test_.make_rig(p, p, T_l, T_r)
    truth = bench_scene.truth_position(rig, 4)
    np.testing.assert_allclose(truth.numpy(), (4 * bench_scene.STEP_M
                                               * R[:, 0]).numpy(), atol=1e-7)
    kinds = (tcam.PINHOLE_RADTAN, tcam.PINHOLE_RADTAN)
    kw = dict(scale=30.0, offset=190.0, step_m=0.25)
    l0, r0 = bench_scene.render_rig(tex, rig, kinds, 0, (48, 64), **kw)
    l1, _ = bench_scene.render_rig(tex, rig, kinds, 1, (48, 64), **kw)
    # 0.25 m at 5 m depth, fx 60: 3 px to the left a frame; the right
    # camera, 0.11 m along the same axis, sees 1.32 px of disparity.
    np.testing.assert_allclose(l1[:, 10:50].numpy(), l0[:, 13:53].numpy(),
                               atol=2e-2)
    assert float((l0 - r0).abs().mean()) > 1.0


def test_render_rig_fisheye_beyond_the_fade_is_flat():
    """A TUM-VI EUCM camera at 512x512: pixels past the fade angle (and
    those whose ray points behind the camera) carry the texture's mean, so
    the detector finds no corner there; the centre is textured."""
    tex = bench_scene.make_texture(0, size=384, octaves=((90.0, 24),
                                                         (60.0, 96)))
    p = tcam.pack_params(tcam.EUCM, TUM_INTR, TUM_DIST, device="cpu")
    T_r = torch.eye(4)
    T_r[0, 3] = 0.1
    rig = test_.make_rig(p, p, torch.eye(4), T_r)
    left, _ = bench_scene.render_rig(tex, rig, (tcam.EUCM, tcam.EUCM), 0,
                                     (512, 512), scale=30.0, offset=190.0)
    v, u = np.mgrid[0:512, 0:512]
    r = np.hypot(u - TUM_INTR[2], v - TUM_INTR[3])
    far = r > 300.0                 # past 90 degrees: mz < 0
    np.testing.assert_allclose(left.numpy()[far], float(tex.mean()),
                               atol=1e-3)
    assert left.numpy()[r < 100.0].std() > 5.0
    score = tdet.fast_score(left)
    assert float(score[torch.from_numpy(far)].max()) == 0.0


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
