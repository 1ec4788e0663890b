"""Parity of the port's tracker paths with the JAX package, each a
composition of the units tested in tests/test_torch_tracker.py: the
bidirectional gather route (forward, backward from the inverse rotation,
return gate; bilinear and bicubic), its two-camera stereo form, the fused
rotation kernel's two-camera batch, and the mono tracker over 5 frames.

Inputs are made with numpy from fixed seeds and handed to both sides; the
JAX Pallas kernels run in interpret mode; everything runs on the CPU in
float32. Tolerance: ok (and every integer table field) equal, positions
within 1e-3 px, warps and angles within 1e-4 — the measured gaps are
~1e-5 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import mono_tracker as jmono
from rsvio_tpu.ops import klt as jklt
from rsvio_tpu.ops import pyramid as jpyr
from rsvio_tpu.ops.pallas.klt_kernel import track_bidirectional_pyramid
from rsvio_tpu_torch.data import bench_scene
from rsvio_tpu_torch.models import mono_tracker as tmono
from rsvio_tpu_torch.ops import klt as tklt
from rsvio_tpu_torch.ops import pyramid as tpyr
from rsvio_tpu_torch.ops.cuda import klt_kernel as kk

torch.set_num_threads(2)

H, W, LEVELS = 72, 104, 3
POS_TOL = 1e-3
A_TOL = 1e-4
ROLL = 0.05


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


def _points(seed, n=40):
    """Interior points plus border-band and outside ones; 3 dead slots."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([4, 4], [W - 5, H - 5], size=(n, 2)).astype(np.float32)
    pts[:6] = [[-6.0, 20.0], [W + 4.0, 30.0], [1.2, 1.7], [W - 2.4, H - 2.2],
               [2.0, 35.0], [50.0, H - 3.0]]
    alive = np.ones(n, bool)
    alive[8:11] = False
    return pts, alive


def _check_tracks(tj, tt_, min_ok):
    pj, Aj, okj = (np.asarray(x) for x in tj)
    pt, At, okt = (x.numpy() for x in tt_)
    np.testing.assert_array_equal(okt, okj)
    assert okj.sum() >= min_ok, "too few tracks to compare"
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(At, Aj, rtol=0, atol=A_TOL)


def _cfgs(rot, interp, mode, lam, policy):
    kw = dict(levels=LEVELS, max_iterations=8, track_rotation=rot,
              interpolation=interp, residual_mode=mode, lm_lambda=lam,
              coarse_level_policy=policy, backend="xla")
    return jklt.KLTConfig(**kw), tklt.KLTConfig(**kw)


@pytest.mark.parametrize("rot,interp,mode,lam,policy", [
    pytest.param(False, "bilinear", "lssd", 0.0, "tolerant",
                 id="translation"),
    pytest.param(True, "bilinear", "ssd", 0.2, "strict", id="rotation"),
    pytest.param(True, "bicubic", "lssd", 0.0, "tolerant",
                 id="bicubic-rotation"),
    pytest.param(False, "bicubic", "ssd", 0.1, "strict",
                 id="bicubic-translation"),
])
def test_bidirectional_gather_route_matches_jax(rot, interp, mode, lam,
                                                policy):
    """Forward, backward from the inverse rotation, return gate."""
    cj, ct = _cfgs(rot, interp, mode, lam, policy)
    img0, img1 = _views(12, [0.0, 0.01], roll=0.04 if rot else 0.0)
    pts, alive = _points(13)
    pj0, pj1 = (jpyr.build_pyramid(jnp.asarray(x), LEVELS)
                for x in (img0, img1))
    pt0, pt1 = (tpyr.build_pyramid(tt(x), LEVELS) for x in (img0, img1))
    out_j = jklt.track_points_bidirectional(pj0, pj1, jnp.asarray(pts),
                                            jnp.asarray(alive), cj)
    out_t = tklt.track_points_bidirectional(pt0, pt1, tt(pts), tt(alive), ct)
    _check_tracks(out_j, out_t, 15)


def test_stereo_gather_route_matches_jax():
    cj, ct = _cfgs(True, "bilinear", "lssd", 0.0, "tolerant")
    a0, a1 = _views(14, [0.0, 0.01], roll=0.03)
    b0, b1 = _views(15, [0.0, 0.015], roll=0.03)
    pts, alive = _points(16)
    pyrs_j = [jpyr.build_pyramid(jnp.asarray(x), LEVELS)
              for x in (a0, b0, a1, b1)]
    pyrs_t = [tpyr.build_pyramid(tt(x), LEVELS) for x in (a0, b0, a1, b1)]
    out_j = jklt.track_points_bidirectional_stereo(
        *pyrs_j, jnp.asarray(pts), jnp.asarray(pts + 0.5),
        jnp.asarray(alive), cj)
    out_t = tklt.track_points_bidirectional_stereo(
        *pyrs_t, tt(pts), tt(pts + 0.5), tt(alive), ct)
    _check_tracks(out_j[:3], out_t[:3], 15)
    _check_tracks(out_j[3:], out_t[3:], 15)


def test_rotation_camera_stacked_batch_matches_pallas():
    """K1-rot with C=2 and per-feature camera indices."""
    a0, a1 = _views(3, [0.0, 0.012], roll=ROLL)
    b0, b1 = _views(4, [0.0, -0.02], roll=-ROLL)
    pts, alive = _points(5)
    cam = np.repeat(np.arange(2, dtype=np.int32), 20)
    kw = dict(max_iterations=10, conv_thresh_sq=1e-4, bidir_thresh_sq=0.4,
              with_rotation=True)
    jp = [jpyr.build_pyramid(jnp.asarray(x), LEVELS) for x in (a0, b0, a1, b1)]
    tp = [tpyr.build_pyramid(tt(x), LEVELS) for x in (a0, b0, a1, b1)]
    pj, thj, okj = track_bidirectional_pyramid(
        tuple(jnp.stack([x, y]) for x, y in zip(jp[0], jp[1])),
        tuple(jnp.stack([x, y]) for x, y in zip(jp[2], jp[3])),
        jnp.asarray(pts), jnp.asarray(alive), interpret=True,
        cam=jnp.asarray(cam), coarse_tolerant=True, **kw)
    src, dims = kk.pack_pyramids(tp[:2])
    dst, _ = kk.pack_pyramids(tp[2:])
    pt, tht, okt = kk.klt_bidir_reference(
        src, dst, dims, tt(pts), tt(alive), tt(cam), coarse_tolerant=True,
        **kw)
    pj, thj, okj = np.asarray(pj), np.asarray(thj), np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert okj.sum() >= 15, "too few tracks to compare"
    np.testing.assert_allclose(pt.numpy()[okj], pj[okj], atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(tht.numpy()[okj], thj[okj], atol=A_TOL, rtol=0)
    np.testing.assert_array_equal(pt.numpy()[~okj], pj[~okj])


# ---------------------------------------------------------------------------
# mono tracker
# ---------------------------------------------------------------------------

MONO_FRAMES = 5


def _mono_cfgs(detect_mode):
    """The config/tartanair.yaml tracker (ratio-2 blurred pyramid, NMS at
    the min distance, threshold 2.5/4000, lambda 0.1), cut to a 3-level
    72x104 image, 32 slots and 10 iterations."""
    kw = dict(levels=3, max_iterations=10, convergence_threshold=0.005,
              lm_lambda=0.1, pyramid_ratio=0.5)
    mk = dict(capacity=32, cell_size=12, detect_margin=8,
              min_score=2.5 / 4000.0, detect_mode=detect_mode, nms_radius=6,
              nms_max_new=16)
    return (jmono.MonoTrackerConfig(klt=jklt.KLTConfig(backend="pallas",
                                                       **kw), **mk),
            tmono.MonoTrackerConfig(klt=tklt.KLTConfig(**kw), **mk))


@pytest.mark.parametrize("detect_mode", ["nms", "grid"])
def test_mono_tracker_matches_jax(detect_mode):
    cj, ct = _mono_cfgs(detect_mode)
    imgs = _views(20, [0.012 * k for k in range(MONO_FRAMES)])
    tj = jmono.init_mono_table(ct.capacity)
    tt_ = tmono.init_mono_table(ct.capacity, device="cpu")
    prev_j = prev_t = None
    tracked = []
    for k, img in enumerate(imgs):
        pj = jpyr.build_pyramid_ratio(jnp.asarray(img), 3, 0.5, blur=True,
                                      blur_sigma=2.0)
        pt = tpyr.build_pyramid_ratio(tt(img), 3, 0.5, blur=True,
                                      blur_sigma=2.0)
        first = k == 0
        tj, sj = jmono.mono_tracker_step(tj, pj if first else prev_j, pj, cj,
                                         first_frame=first)
        tt_, st = tmono.mono_tracker_step(tt_, pt if first else prev_t, pt,
                                          ct, first_frame=first)
        prev_j, prev_t = pj, pt
        for f in ("alive", "fid", "age", "next_id"):
            np.testing.assert_array_equal(getattr(tt_, f).numpy(),
                                          np.asarray(getattr(tj, f)),
                                          err_msg=f"frame {k} {f}")
        np.testing.assert_allclose(tt_.pos.numpy(), np.asarray(tj.pos),
                                   rtol=0, atol=POS_TOL)
        np.testing.assert_allclose(tt_.A.numpy(), np.asarray(tj.A), rtol=0,
                                   atol=A_TOL)
        assert int(st["tracked"]) == int(sj["tracked"])
        tracked.append(int(st["tracked"]))
    assert min(tracked[1:]) >= 8, tracked
