"""Parity of the port's tracker family with the JAX package: image sampling
(``ops.interp``), ``se2_exp``, the ratio pyramid, Shi-Tomasi scoring and NMS
selection, the per-level KLT kernel K2 (``klt_level_reference`` vs the Pallas
``track_level``) and ``track_points`` on both routes (kernel route: the JAX
Pallas kernels in interpret mode; gather route: ``backend="xla"``, bilinear
and bicubic). The bidirectional gather route and the mono tracker are in
tests/test_torch_tracker_paths.py.

Inputs are made with numpy from fixed seeds (the bench-scene texture is
numpy noise upscaled) and handed to both sides; everything runs on the CPU
in float32.

Tolerances:
  * sampling, se2_exp, Shi-Tomasi: 1e-5 relative (plus an absolute floor
    scaled to the values) — the same fp32 operations, up to the order of
    short sums;
  * the ratio pyramid: 1e-3 absolute on 0-255 images (~4e-6 relative). The
    triangle-filter weights are computed by two implementations that agree
    to a few ulps; non-0.5 ratios also place the sample centers a few ulps
    apart;
  * NMS candidates: exact (comparisons, max pooling and integer
    arithmetic; ties broken by the lowest linear index on both sides);
  * tracking: ok equal, positions within 1e-3 px, warps within 1e-4 — the
    same tolerance as the kernel tests; the measured gaps are ~1e-5 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.ops import detect as jdet
from rsvio_tpu.ops import interp as jinterp
from rsvio_tpu.ops import klt as jklt
from rsvio_tpu.ops import lie as jlie
from rsvio_tpu.ops import pyramid as jpyr
from rsvio_tpu.ops.pallas.klt_kernel import track_level
from rsvio_tpu_torch.data import bench_scene
from rsvio_tpu_torch.ops import detect as tdet
from rsvio_tpu_torch.ops import interp as tinterp
from rsvio_tpu_torch.ops import klt as tklt
from rsvio_tpu_torch.ops import lie as tlie
from rsvio_tpu_torch.ops import pyramid as tpyr
from rsvio_tpu_torch.ops.cuda import klt_kernel as kk

torch.set_num_threads(2)

H, W, LEVELS = 72, 104, 3
POS_TOL = 1e-3
A_TOL = 1e-4
THETA_TOL = 1e-4


def tt(x):
    return torch.from_numpy(np.array(x))


def _views(seed, shifts, roll=0.0):
    """Float32 (H, W) renders at x offsets `shifts` (0.01 m = 1.2 px), all
    but the first rolled by `roll` rad."""
    tex = bench_scene.make_texture(seed, size=512,
                                   octaves=((90.0, 24), (60.0, 96)))
    return [bench_scene.render(tex, dx, 0.2 * dx, shape=(H, W), fx=120.0,
                               plane_z=3.0, scale=40.0, offset=200.0,
                               roll=roll if k else 0.0).numpy()
            for k, dx in enumerate(shifts)]


def _blocky(seed, h=H, w=W):
    """Piecewise-constant texture: plateaus give tied scores."""
    rng = np.random.default_rng(seed)
    return (np.kron(rng.uniform(0, 1, (h // 4, w // 4)), np.ones((4, 4)))
            * 200 + 30).astype(np.float32)


def _sample_points(seed, n=300):
    """Points inside, on the border and outside the image."""
    rng = np.random.default_rng(seed)
    return rng.uniform([-3.0, -3.0], [W + 2.0, H + 2.0],
                       size=(n, 2)).astype(np.float32)


# ---------------------------------------------------------------------------
# interp, se2_exp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bilinear", "bilinear_with_grad",
                                  "bicubic", "bicubic_with_grad"])
def test_interp_matches_jax(name):
    img = _views(0, [0.0])[0]
    xy = _sample_points(1)
    out_j = jax.vmap(getattr(jinterp, name), in_axes=(None, 0))(
        jnp.asarray(img), jnp.asarray(xy))
    out_t = getattr(tinterp, name)(tt(img), tt(xy))
    for a, b in zip(out_t, out_j):
        b = np.asarray(b)
        if b.dtype == bool:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=2e-3)
    assert 0.5 * len(xy) < int(out_t[-1].sum()) < len(xy)


def test_in_bounds_matches_jax():
    xy = _sample_points(2)
    for margin in (0.0, 2.0):
        j = jax.vmap(lambda p: jinterp.in_bounds(p, (H, W), margin))(
            jnp.asarray(xy))
        np.testing.assert_array_equal(
            tinterp.in_bounds(tt(xy), (H, W), margin).numpy(), np.asarray(j))


def test_se2_exp_matches_jax():
    rng = np.random.default_rng(3)
    xi = rng.normal(size=(40, 3)).astype(np.float32)
    xi[:10, 2] *= 1e-5            # theta^2 < 1e-8: Taylor branch
    xi[10, 2] = 0.0
    j = jax.vmap(jlie.se2_exp)(jnp.asarray(xi))
    np.testing.assert_allclose(tlie.se2_exp(tt(xi)).numpy(), np.asarray(j),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# pyramid, detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratio,blur,sigma", [
    (0.5, True, 2.0), (0.5, False, 0.7), (0.7, False, 0.7), (0.6, True, 0.7)])
def test_build_pyramid_ratio_matches_jax(ratio, blur, sigma):
    img = _views(4, [0.0])[0]
    pj = jpyr.build_pyramid_ratio(jnp.asarray(img), 4, ratio, blur=blur,
                                  blur_sigma=sigma)
    pt = tpyr.build_pyramid_ratio(tt(img), 4, ratio, blur=blur,
                                  blur_sigma=sigma)
    assert len(pt) == len(pj)
    for a, b in zip(pt, pj):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-3)


def test_gaussian_blur3_and_box3_match_jax():
    img = _views(5, [0.0])[0]
    np.testing.assert_allclose(
        tpyr.gaussian_blur3(tt(img)).numpy(),
        np.asarray(jpyr.gaussian_blur3(jnp.asarray(img))), rtol=1e-6,
        atol=1e-4)
    np.testing.assert_allclose(
        tdet._box3(tt(img)).numpy(),
        np.asarray(jdet._box3(jnp.asarray(img))), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("kind", ["render", "blocky"])
def test_shi_tomasi_score_matches_jax(kind):
    img = _views(6, [0.0])[0] if kind == "render" else _blocky(6)
    j = np.asarray(jdet.shi_tomasi_score(jnp.asarray(img)))
    t = tdet.shi_tomasi_score(tt(img)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("radius,score_kind", [
    (3, "fast"), (6, "fast"), (5, "shi_tomasi")])
def test_nms_select_matches_jax(radius, score_kind):
    """Plateaus of the blocky texture make many tied window maxima."""
    img = _blocky(7)
    if score_kind == "fast":
        score, floor = np.asarray(jdet.fast_score(jnp.asarray(img))), 5.0
    else:
        score = np.asarray(jdet.shi_tomasi_score(jnp.asarray(img)))
        floor = 1.0
    rng = np.random.default_rng(8)
    occ = rng.uniform([0, 0], [W, H], size=(12, 2)).astype(np.float32)
    occ_ok = rng.uniform(size=12) < 0.7
    xy_j, ok_j = jdet.nms_select(jnp.asarray(score), jnp.asarray(occ),
                                 jnp.asarray(occ_ok), radius, margin=5,
                                 min_score=floor, max_new=48)
    xy_t, ok_t = tdet.nms_select(tt(score), tt(occ), tt(occ_ok), radius,
                                 margin=5, min_score=floor, max_new=48)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    assert 4 <= int(ok_t.sum()) < 48 or radius == 3


# ---------------------------------------------------------------------------
# track_points and the bidirectional entry points, both routes
# ---------------------------------------------------------------------------

def _track_inputs(seed, roll):
    img0, img1 = _views(seed, [0.0, 0.01], roll=roll)
    rng = np.random.default_rng(seed + 1)
    n = 40
    pts = rng.uniform([4, 4], [W - 5, H - 5], size=(n, 2)).astype(np.float32)
    pts[:6] = [[-6.0, 20.0], [W + 4.0, 30.0], [1.2, 1.7], [W - 2.4, H - 2.2],
               [2.0, 35.0], [50.0, H - 3.0]]
    alive = np.ones(n, bool)
    alive[8:11] = False
    ang = rng.uniform(-0.1, 0.1, n).astype(np.float32)
    A0 = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                   np.stack([np.sin(ang), np.cos(ang)], -1)], -2)
    start = pts + rng.normal(0, 0.3, (n, 2))
    return (img0, img1, pts, start.astype(np.float32), A0.astype(np.float32),
            alive)


def _check_tracks(tj, tt_, min_ok):
    pj, Aj, okj = (np.asarray(x) for x in tj)
    pt, At, okt = (x.numpy() for x in tt_)
    np.testing.assert_array_equal(okt, okj)
    assert okj.sum() >= min_ok, "too few tracks to compare"
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(At, Aj, rtol=0, atol=A_TOL)


TRACK_CASES = [
    # (JAX backend, track_rotation, interpolation, residual_mode, lm_lambda,
    #  coarse_level_policy)
    pytest.param("pallas", False, "bilinear", "lssd", 0.0, "tolerant",
                 id="kernel-translation"),
    pytest.param("pallas", True, "bilinear", "ssd", 0.2, "strict",
                 id="kernel-rotation"),
    pytest.param("xla", False, "bilinear", "lssd", 0.0, "tolerant",
                 id="gather-translation"),
    pytest.param("xla", True, "bilinear", "ssd", 0.2, "strict",
                 id="gather-rotation"),
    pytest.param("xla", True, "bicubic", "lssd", 0.0, "tolerant",
                 id="gather-bicubic-rotation"),
    pytest.param("xla", False, "bicubic", "ssd", 0.1, "strict",
                 id="gather-bicubic-translation"),
]


def _cfgs(backend, rot, interp, mode, lam, policy):
    kw = dict(levels=LEVELS, max_iterations=8, track_rotation=rot,
              interpolation=interp, residual_mode=mode, lm_lambda=lam,
              coarse_level_policy=policy)
    # The port's "auto" is the kernel route (JAX's "auto" off a TPU is the
    # gather route, so the JAX side names its backend).
    return (jklt.KLTConfig(backend=backend, **kw),
            tklt.KLTConfig(backend="auto" if backend == "pallas" else backend,
                           **kw))


@pytest.mark.parametrize("backend,rot,interp,mode,lam,policy", TRACK_CASES)
def test_track_points_matches_jax(backend, rot, interp, mode, lam, policy):
    cj, ct = _cfgs(backend, rot, interp, mode, lam, policy)
    img0, img1, pts, start, A0, alive = _track_inputs(10, 0.04 if rot else 0)
    pj0, pj1 = (jpyr.build_pyramid(jnp.asarray(x), LEVELS)
                for x in (img0, img1))
    pt0, pt1 = (tpyr.build_pyramid(tt(x), LEVELS) for x in (img0, img1))
    out_j = jklt.track_points(pj0, pj1, jnp.asarray(pts), jnp.asarray(start),
                              jnp.asarray(A0), jnp.asarray(alive), cj)
    out_t = tklt.track_points(pt0, pt1, tt(pts), tt(start), tt(A0),
                              tt(alive), ct)
    _check_tracks(out_j, out_t, 20)
    assert not out_t[2][8:11].any(), "dead slots stay dead"


@pytest.mark.parametrize("rot", [False, True], ids=["translation", "rot"])
@pytest.mark.parametrize("lvl,mode,lam", [(0, "lssd", 0.0), (2, "ssd", 0.3)])
def test_level_kernel_matches_pallas(rot, lvl, mode, lam):
    """K2: one level from perturbed start positions (and, with rotation,
    start angles inside the theta gate); dead features keep their start.
    Failed tracks end at their last Gauss-Newton iterate, held to the same
    tolerance as the ok ones."""
    img0, img1, pts, _, _, alive = _track_inputs(30, 0.05 if rot else 0.0)
    rng = np.random.default_rng(31)
    s = 2.0 ** lvl
    ps = (pts / s).astype(np.float32)
    pd = (ps + rng.normal(0, 0.5, ps.shape)).astype(np.float32)
    th0 = (rng.uniform(-0.2, 0.2, len(pts)) if rot
           else np.zeros(len(pts))).astype(np.float32)
    kw = dict(max_iterations=10, conv_thresh_sq=1e-4, residual_mode=mode,
              lm_lambda=lam, with_rotation=rot)
    pj, thj, okj = (np.asarray(x) for x in track_level(
        jpyr.build_pyramid(jnp.asarray(img0), LEVELS)[lvl],
        jpyr.build_pyramid(jnp.asarray(img1), LEVELS)[lvl], jnp.asarray(ps),
        jnp.asarray(pd), jnp.asarray(th0), jnp.asarray(alive),
        interpret=True, **kw))
    pt, tht, okt = (x.numpy() for x in kk.klt_level_reference(
        tpyr.build_pyramid(tt(img0), LEVELS)[lvl][None].contiguous(),
        tpyr.build_pyramid(tt(img1), LEVELS)[lvl][None].contiguous(),
        tt(ps), tt(pd), tt(th0), tt(alive),
        torch.zeros(len(pts), dtype=torch.int32), **kw))
    np.testing.assert_array_equal(okt, okj)
    assert okj.sum() >= 15, "too few tracks to compare"
    np.testing.assert_allclose(pt, pj, atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(tht, thj, atol=THETA_TOL, rtol=0)
    np.testing.assert_array_equal(pt[8:11], pd[8:11])
    np.testing.assert_array_equal(tht[8:11], th0[8:11])


def _two_camera_level_inputs(rot, n=37):
    """Level 1 of two cameras' image pairs as (2, H, W) stacks, n features
    whose cameras interleave (0, 1, 0, ...), start positions 0.5 px off and,
    with rotation, start angles in +-0.33 rad (just inside the theta gate,
    0.33^2 < 0.12)."""
    roll = 0.05 if rot else 0.0
    pairs = [_views(seed, [0.0, 0.01], roll=roll) for seed in (33, 34)]
    src, dst = ([tpyr.build_pyramid(tt(p[k]), 2)[1] for p in pairs]
                for k in (0, 1))
    rng = np.random.default_rng(35)
    ps = rng.uniform([2, 2], [W / 2 - 3, H / 2 - 3], size=(n, 2))
    ps[:3] = [[-3.0, 10.0], [1.5, 1.9], [W / 2 - 2.5, 12.0]]
    pd = ps + rng.normal(0, 0.5, ps.shape)
    th0 = (rng.uniform(-0.33, 0.33, n) if rot else np.zeros(n))
    alive = np.ones(n, bool)
    alive[[4, 9]] = False
    cam = (np.arange(n) % 2).astype(np.int32)
    return (torch.stack(src).contiguous(), torch.stack(dst).contiguous(),
            ps.astype(np.float32), pd.astype(np.float32),
            th0.astype(np.float32), alive, cam)


@pytest.mark.parametrize("rot", [False, True], ids=["translation", "rot"])
def test_level_kernel_two_cameras_matches_pallas(rot):
    """K2's contract on a camera stack: (2, H, W) images, cameras
    interleaved, N = 37, start angles up to 0.33 rad. Every row is held to
    Pallas: ok tracks, failed ones at their last Gauss-Newton iterate, dead
    ones at their start."""
    src, dst, ps, pd, th0, alive, cam = _two_camera_level_inputs(rot)
    kw = dict(max_iterations=10, conv_thresh_sq=1e-4, with_rotation=rot)
    pj, thj, okj = (np.asarray(x) for x in track_level(
        jnp.asarray(src.numpy()), jnp.asarray(dst.numpy()), jnp.asarray(ps),
        jnp.asarray(pd), jnp.asarray(th0), jnp.asarray(alive),
        interpret=True, cam=jnp.asarray(cam), **kw))
    pt, tht, okt = (x.numpy() for x in kk.klt_level_reference(
        src, dst, tt(ps), tt(pd), tt(th0), tt(alive), tt(cam), **kw))
    np.testing.assert_array_equal(okt, okj)
    assert okj.sum() >= 20, "too few tracks to compare"
    assert not okt[:3].any(), "a template outside the margin fails"
    np.testing.assert_allclose(pt, pj, atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(tht, thj, atol=THETA_TOL, rtol=0)
    np.testing.assert_array_equal(pt[[4, 9]], pd[[4, 9]])
    np.testing.assert_array_equal(tht[[4, 9]], th0[[4, 9]])


@pytest.mark.parametrize("rot", [False, True], ids=["translation", "rot"])
def test_level_plain_version_non_finite_theta0(rot):
    """Start angles NaN, +inf and -inf: with rotation such a row takes no
    step (its samples are NaN) and fails, keeping pos_dst0 bit for bit and
    its angle; the translation variant ignores the angle and returns it.
    Every other row gets what it gets in a run without those rows."""
    src, dst, ps, pd, th0, alive, cam = _two_camera_level_inputs(rot)
    bad = np.array([5, 12, 20])
    th0[bad] = [np.nan, np.inf, -np.inf]
    good = np.setdiff1d(np.arange(len(ps)), bad)
    kw = dict(max_iterations=10, conv_thresh_sq=1e-4, with_rotation=rot)

    def run(rows, th):
        return kk.klt_level_reference(
            src, dst, tt(ps[rows]), tt(pd[rows]), tt(th[rows]),
            tt(alive[rows]), tt(cam[rows]), **kw)

    p, th, ok = run(np.arange(len(ps)), th0)
    p_g, th_g, ok_g = run(good, th0)
    assert torch.equal(p[good], p_g) and torch.equal(ok[good], ok_g)
    assert torch.equal(th[good], th_g)
    assert int(ok_g.sum()) >= 20
    np.testing.assert_array_equal(th[bad].numpy(), th0[bad])
    if rot:
        assert not ok[bad].any()
        assert torch.equal(p[bad], tt(pd[bad]))
    else:
        p_0, _, ok_0 = run(bad, np.zeros_like(th0))
        assert torch.equal(p[bad], p_0) and torch.equal(ok[bad], ok_0)
        assert bool(ok_0.all())


@pytest.mark.parametrize("backend,interp,want", [
    ("auto", "bilinear", "pallas"), ("pallas", "bilinear", "pallas"),
    ("xla", "bilinear", "xla"), ("auto", "bicubic", "xla"),
    ("xla", "bicubic", "xla")])
def test_resolve_backend(backend, interp, want):
    """As JAX's resolve_backend on a TPU, where "auto" is the kernel."""
    cfg = tklt.KLTConfig(backend=backend, interpolation=interp)
    assert tklt.resolve_backend(cfg) == want
    if backend != "auto":
        assert jklt.resolve_backend(jklt.KLTConfig(
            backend=backend, interpolation=interp)) == want


def test_bicubic_on_the_kernel_raises_like_jax():
    with pytest.raises(ValueError):
        jklt.resolve_backend(jklt.KLTConfig(backend="pallas",
                                            interpolation="bicubic"))
    with pytest.raises(ValueError):
        tklt.resolve_backend(tklt.KLTConfig(backend="pallas",
                                            interpolation="bicubic"))
