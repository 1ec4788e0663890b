"""Parity of the port's fused KLT kernel's plain version with the JAX Pallas
kernel K1 ``track_bidirectional_pyramid``, translation and
``with_rotation`` (K2 ``track_level`` and the two-camera rotation batch:
tests/test_torch_tracker.py and tests/test_torch_tracker_paths.py).

The JAX side runs the Pallas kernels in interpret mode on the CPU, as the JAX
package's own kernel tests do; the port runs ``klt_bidir_reference`` and
``klt_level_reference``, the plain PyTorch versions of its CUDA kernels,
which is what the port's wrappers route CPU tensors to. Inputs are views of
a seeded multi-scale texture (shifted, and for rotation also rolled by
0.05 rad), with features in the border band, outside the image and in dead
slots.

Tolerance: ``ok`` must be equal, positions within 1e-3 px and angles within
1e-4 rad where ok. Both sides compute the same fp32 operations except for
the order of the 256-term patch sums (and, with rotation, the cos/sin
implementation), which moves positions by ~4e-6 px and angles by ~1e-7 rad
(measured); the tolerances leave room for one extra or one fewer
Gauss-Newton step of a feature sitting on its convergence threshold.

The CUDA kernels themselves are compared with the plain versions by the
``gpu`` tests (here and in tests/test_torch_gpu.py), which need a card and
are skipped here.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvio_tpu.ops import pyramid as jpyr
from rsvio_tpu.ops.pallas.klt_kernel import track_bidirectional_pyramid
from rsvio_tpu_torch.data import bench_scene
from rsvio_tpu_torch.ops import klt as tklt
from rsvio_tpu_torch.ops import pyramid as tpyr
from rsvio_tpu_torch.ops.cuda import klt_kernel as kk

torch.set_num_threads(2)

H, W, LEVELS = 72, 104, 3
POS_TOL = 1e-3
THETA_TOL = 1e-4
ROLL = 0.05


def _views(seed, shifts, roll=0.0):
    """Float32 (H, W) renders of one texture seen from x offsets `shifts`
    (metres; 0.01 m = 1.2 px at these settings), all but the first rolled
    by `roll` rad."""
    tex = bench_scene.make_texture(seed, size=512,
                                   octaves=((90.0, 24), (60.0, 96)))
    return [bench_scene.render(tex, dx, 0.2 * dx, shape=(H, W), fx=120.0,
                               plane_z=3.0, scale=40.0, offset=200.0,
                               roll=roll if k else 0.0).numpy()
            for k, dx in enumerate(shifts)]


def _points(seed, n):
    """Interior points plus border-band, outside-image and far-away ones."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([4, 4], [W - 5, H - 5], size=(n, 2)).astype(np.float32)
    pts[:8] = [[-6.0, 20.0], [W + 4.0, 30.0], [1.2, 1.7], [W - 2.4, H - 2.2],
               [2.0, 35.0], [50.0, H - 3.0], [1e5, -1e5], [0.4, 0.6]]
    alive = np.ones(n, bool)
    alive[8:11] = False
    return pts, alive


def _jax_pyr(img):
    return jpyr.build_pyramid(jnp.asarray(img), LEVELS)


def _torch_pyr(img):
    return tpyr.build_pyramid(torch.from_numpy(img), LEVELS)


def _compare(pj, okj, pt, okt, alive, thj=None, tht=None):
    pj, okj = np.asarray(pj), np.asarray(okj)
    pt, okt = pt.numpy(), okt.numpy()
    np.testing.assert_array_equal(okj, okt)
    assert okj.sum() >= 0.5 * alive.sum(), "too few tracks to compare"
    np.testing.assert_allclose(pt[okj], pj[okj], atol=POS_TOL, rtol=0)
    if thj is not None:
        np.testing.assert_allclose(tht.numpy()[okj], np.asarray(thj)[okj],
                                   atol=THETA_TOL, rtol=0)
    # Failed features keep their source position on both sides.
    np.testing.assert_array_equal(pt[~okj], pj[~okj])


CASES = [
    # (coarse_tolerant, residual_mode, lm_lambda)
    (True, "lssd", 0.0),
    (False, "ssd", 0.5),
    (False, "lssd", 0.5),
    (True, "ssd", 0.0),
]


@pytest.mark.parametrize("tolerant,mode,lam", CASES)
def test_single_camera_matches_pallas(tolerant, mode, lam):
    img0, img1 = _views(1, [0.0, 0.017])
    pts, alive = _points(2, 48)
    kw = dict(max_iterations=10, conv_thresh_sq=1e-4, bidir_thresh_sq=0.4,
              residual_mode=mode, lm_lambda=lam)
    pj, _, okj = track_bidirectional_pyramid(
        _jax_pyr(img0), _jax_pyr(img1), jnp.asarray(pts), jnp.asarray(alive),
        interpret=True, coarse_tolerant=tolerant, **kw)
    src, dims = kk.pack_pyramids([_torch_pyr(img0)])
    dst, _ = kk.pack_pyramids([_torch_pyr(img1)])
    pt, th, okt = kk.klt_bidir_reference(
        src, dst, dims, torch.from_numpy(pts), torch.from_numpy(alive),
        torch.zeros(len(pts), dtype=torch.int32), coarse_tolerant=tolerant,
        **kw)
    _compare(pj, okj, pt, okt, alive)
    assert not okt[8:11].any(), "dead slots must stay dead"
    assert not okt[[0, 1, 6]].any(), "outside-image features must fail"
    assert (th == 0).all()


def test_camera_stacked_batch_matches_pallas():
    """C=2: each camera tracks in its own images, one call for both."""
    a0, a1 = _views(3, [0.0, 0.012])
    b0, b1 = _views(4, [0.0, -0.02])
    pts, alive = _points(5, 40)
    cam = np.repeat(np.arange(2, dtype=np.int32), 20)
    kw = dict(max_iterations=10, conv_thresh_sq=1e-4, bidir_thresh_sq=0.4)
    pj, _, okj = track_bidirectional_pyramid(
        tuple(jnp.stack([x, y]) for x, y in zip(_jax_pyr(a0), _jax_pyr(b0))),
        tuple(jnp.stack([x, y]) for x, y in zip(_jax_pyr(a1), _jax_pyr(b1))),
        jnp.asarray(pts), jnp.asarray(alive), interpret=True,
        cam=jnp.asarray(cam), coarse_tolerant=True, **kw)
    src, dims = kk.pack_pyramids([_torch_pyr(a0), _torch_pyr(b0)])
    dst, _ = kk.pack_pyramids([_torch_pyr(a1), _torch_pyr(b1)])
    pt, _, okt = kk.klt_bidir_reference(
        src, dst, dims, torch.from_numpy(pts), torch.from_numpy(alive),
        torch.from_numpy(cam), coarse_tolerant=True, **kw)
    _compare(pj, okj, pt, okt, alive)


def test_stereo_entry_equals_two_single_calls():
    """track_points_bidirectional_stereo (one camera-stacked pass) gives
    exactly what two per-camera passes give."""
    a0, a1 = _views(6, [0.0, 0.01])
    b0, b1 = _views(7, [0.0, 0.015])
    p0, alive = _points(8, 24)
    p1 = p0 + np.float32(0.5)
    cfg = tklt.KLTConfig(levels=LEVELS, max_iterations=8)
    pa, pb, pc, pd = (_torch_pyr(x) for x in (a0, b0, a1, b1))
    t0, t1 = torch.from_numpy(p0), torch.from_numpy(p1)
    al = torch.from_numpy(alive)
    q0, A0, ok0, q1, A1, ok1 = tklt.track_points_bidirectional_stereo(
        pa, pb, pc, pd, t0, t1, al, cfg)
    r0, _, k0 = tklt.track_points_bidirectional(pa, pc, t0, al, cfg)
    r1, _, k1 = tklt.track_points_bidirectional(pb, pd, t1, al, cfg)
    assert torch.equal(q0, r0) and torch.equal(ok0, k0)
    assert torch.equal(q1, r1) and torch.equal(ok1, k1)
    assert torch.equal(A0, torch.eye(2).expand_as(A0))


@pytest.mark.parametrize("tolerant,mode,lam", CASES)
def test_rotation_variant_matches_pallas(tolerant, mode, lam):
    """K1-rot: the SE2 variant on a pair rolled by 0.05 rad recovers the
    roll and matches the Pallas kernel, angles included."""
    img0, img1 = _views(1, [0.0, 0.01], roll=ROLL)
    pts, alive = _points(2, 48)
    kw = dict(max_iterations=10, conv_thresh_sq=1e-4, bidir_thresh_sq=0.4,
              residual_mode=mode, lm_lambda=lam, with_rotation=True)
    pj, thj, okj = track_bidirectional_pyramid(
        _jax_pyr(img0), _jax_pyr(img1), jnp.asarray(pts), jnp.asarray(alive),
        interpret=True, coarse_tolerant=tolerant, **kw)
    src, dims = kk.pack_pyramids([_torch_pyr(img0)])
    dst, _ = kk.pack_pyramids([_torch_pyr(img1)])
    pt, tht, okt = kk.klt_bidir_reference(
        src, dst, dims, torch.from_numpy(pts), torch.from_numpy(alive),
        torch.zeros(len(pts), dtype=torch.int32), coarse_tolerant=tolerant,
        **kw)
    _compare(pj, okj, pt, okt, alive, thj, tht)
    assert float(tht[okt].mean()) < -0.6 * ROLL, "the roll is recovered"
    assert not okt[8:11].any(), "dead slots must stay dead"


def test_rotation_variant_runs_and_bad_options_raise():
    """Rotation, the gather route and bicubic sampling run; what no route
    implements raises ValueError."""
    img = torch.from_numpy(_views(9, [0.0])[0])
    src, dims = kk.pack_pyramids([tpyr.build_pyramid(img, LEVELS)])
    pos = torch.full((3, 2), 30.0)
    args = (src, src, dims, pos, torch.ones(3, dtype=torch.bool),
            torch.zeros(3, dtype=torch.int32))
    for fn in (kk.klt_bidir, kk.klt_bidir_reference):
        p, th, ok = fn(*args, with_rotation=True)
        assert ok.all() and torch.equal(p, pos)   # identity track
        assert torch.equal(th, torch.zeros(3))
    pyr = tpyr.build_pyramid(img, LEVELS)
    for good in (tklt.KLTConfig(levels=LEVELS, track_rotation=True),
                 tklt.KLTConfig(levels=LEVELS, backend="xla"),
                 tklt.KLTConfig(levels=LEVELS, interpolation="bicubic")):
        p, A, ok = tklt.track_points_bidirectional(pyr, pyr, pos, args[4],
                                                   good)
        assert ok.all()
        assert float((p - pos).abs().max()) <= POS_TOL
    for bad in (tklt.KLTConfig(levels=LEVELS, backend="pallas",
                               interpolation="bicubic"),
                tklt.KLTConfig(levels=LEVELS, backend="triton"),
                tklt.KLTConfig(levels=LEVELS, interpolation="nearest")):
        with pytest.raises(ValueError):
            tklt.track_points_bidirectional(pyr, pyr, pos, args[4], bad)
    with pytest.raises(ValueError):
        kk.klt_bidir(*args, residual_mode="l1")


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    img = torch.from_numpy(_views(10, [0.0])[0])
    src, dims = kk.pack_pyramids([tpyr.build_pyramid(img, LEVELS)])
    pos = torch.full((4, 2), 30.0)
    alive = torch.ones(4, dtype=torch.bool)
    cam = torch.zeros(4, dtype=torch.int32)
    before = kk.klt_bidir.launches
    _, _, ok = kk.klt_bidir(src, src, dims, pos, alive, cam)
    assert ok.all()                      # identity track on the CPU path
    assert kk.klt_bidir.launches == before   # the plain version is no launch
    with pytest.raises(TypeError):
        kk.klt_bidir(src, src, dims, pos.double(), alive, cam)
    with pytest.raises(TypeError):
        kk.klt_bidir(src, src, dims, pos, alive, cam.long())
    with pytest.raises(ValueError):
        kk.klt_bidir(src[:, :-1], src, dims, pos, alive, cam)
    with pytest.raises(ValueError):
        kk.klt_bidir(src, src, dims, pos.t().contiguous().t(), alive, cam)
    # klt_level: one (C, H, W) level, level coordinates
    h, w = dims[0]
    lvl = src[:, :h * w].reshape(1, h, w)
    theta = torch.zeros(4)
    before = kk.klt_level.launches
    p, th, ok = kk.klt_level(lvl, lvl, pos, pos, theta, alive, cam,
                             with_rotation=True)
    assert ok.all() and torch.equal(p, pos) and torch.equal(th, theta)
    assert kk.klt_level.launches == before
    with pytest.raises(ValueError):
        kk.klt_level(src, src, pos, pos, theta, alive, cam)
    with pytest.raises(TypeError):
        kk.klt_level(lvl, lvl, pos, pos, theta.double(), alive, cam)
    with pytest.raises(ValueError):
        kk.klt_level(lvl, lvl[:, 1:], pos, pos, theta, alive, cam)


@pytest.mark.parametrize("rot", [False, True])
def test_plain_version_counts_the_pixels_it_reads(rot):
    """work["touched"]: a template reads its 19x19 support in src, each
    Gauss-Newton step its 17x17 support in dst (rotation at theta 0: the
    same taps); a feature at a corner reads only the clamped pixels, a dead
    one nothing. Images are distinct tensors, so each is keyed apart."""
    img = torch.from_numpy(_views(14, [0.0])[0])[None]
    dst = img.clone()
    pos = torch.tensor([[40.3, 30.6], [1.0, 1.0], [60.0, 40.0]])
    alive = torch.tensor([True, True, False])
    work = {"templates": 0, "iterations": 0}
    p, _, ok = kk.klt_level_reference(
        img, dst, pos, pos, torch.zeros(3), alive,
        torch.zeros(3, dtype=torch.int32), max_iterations=10,
        with_rotation=rot, work=work)
    assert bool(ok[0]) and not ok[1:].any()
    assert float((p[0] - pos[0]).abs().max()) < 1e-3
    # Corner feature: template rows/cols clamp to 0..10 (11 of 19 each);
    # its patch fails the margin, so it takes no step.
    assert work["templates"] == 2 and work["iterations"] == 1
    touched = {k: int(m.sum()) for k, m in work["touched"].items()}
    assert touched == {img.data_ptr(): 19 * 19 + 11 * 11,
                       dst.data_ptr(): 17 * 17}


@functools.lru_cache(maxsize=None)
def _chain_run(rot, tolerant):
    """klt_bidir_reference with work counters, and its forward direction
    alone composed from klt_level_reference as klt_bidir_reference composes
    it: (work, forward work, forward ok, alive)."""
    img0, img1 = _views(1, [0.0, 0.017], roll=ROLL if rot else 0.0)
    pts, alive = _points(2, 48)
    p0, p1 = _torch_pyr(img0), _torch_pyr(img1)
    src, dims = kk.pack_pyramids([p0])
    dst, _ = kk.pack_pyramids([p1])
    pos, al = torch.from_numpy(pts), torch.from_numpy(alive)
    cam = torch.zeros(len(pts), dtype=torch.int32)
    kw = dict(max_iterations=10, with_rotation=rot)
    work = {"templates": 0, "iterations": 0}
    pos_fwd, _, _ = kk.klt_bidir_reference(src, dst, dims, pos, al, cam,
                                           coarse_tolerant=tolerant,
                                           work=work, **kw)
    fwd = {"templates": 0, "iterations": 0}

    def level(lvl, cur, th):
        s = 0.5 ** lvl
        p, t, ok = kk.klt_level_reference(p0[lvl][None], p1[lvl][None],
                                          pos * s, cur * s, th, al, cam,
                                          work=fwd, **kw)
        return p / s, t, ok

    (cur, _), ok_fwd = kk.coarse_to_fine(
        LEVELS, level, (pos, torch.zeros(len(pts))), al, tolerant)
    # The composition is the kernel's forward direction.
    assert torch.equal(pos_fwd[ok_fwd], cur[ok_fwd])
    return work, fwd, ok_fwd, al


CHAIN_CASES = [(False, True), (False, False), (True, True), (True, False)]


@pytest.mark.parametrize("rot,tolerant", CHAIN_CASES)
def test_chain_counts_templates_and_steps(rot, tolerant):
    """work["chain"]: per feature, its templates plus Gauss-Newton steps
    over both directions and all levels."""
    work, _, _, _ = _chain_run(rot, tolerant)
    chain = work["chain"]
    assert chain.dtype == torch.int64 and chain.shape == (48,)
    assert int(chain.sum()) == work["templates"] + work["iterations"]
    assert int(chain.max()) <= 2 * LEVELS * (1 + 10)


@pytest.mark.parametrize("rot,tolerant", CHAIN_CASES)
def test_chain_is_zero_for_dead_features(rot, tolerant):
    work, _, _, alive = _chain_run(rot, tolerant)
    assert not work["chain"][~alive].any()
    assert bool((work["chain"][alive] >= LEVELS).all())


@pytest.mark.parametrize("rot,tolerant", CHAIN_CASES)
def test_chain_has_no_backward_links_after_a_forward_failure(rot, tolerant):
    """A feature that fails forward walks only its forward links; one that
    passes adds at least one backward template per level."""
    work, fwd, ok_fwd, alive = _chain_run(rot, tolerant)
    failed = alive & ~ok_fwd
    assert int(failed.sum()) >= 3     # the outside-image features at least
    assert torch.equal(work["chain"][failed], fwd["chain"][failed])
    assert bool((work["chain"][ok_fwd]
                 >= fwd["chain"][ok_fwd] + LEVELS).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version(cuda_device):
    """Kernel vs plain version on the same CUDA tensors (C=2, both
    policies)."""
    a0, a1 = _views(11, [0.0, 0.012])
    b0, b1 = _views(12, [0.0, 0.02])
    pts, alive = _points(13, 64)
    cam = np.repeat(np.arange(2, dtype=np.int32), 32)
    dev = cuda_device
    src, dims = kk.pack_pyramids([tpyr.build_pyramid(torch.from_numpy(x).to(dev), LEVELS)
                                  for x in (a0, b0)])
    dst, _ = kk.pack_pyramids([tpyr.build_pyramid(torch.from_numpy(x).to(dev), LEVELS)
                               for x in (a1, b1)])
    args = (src, dst, dims, torch.from_numpy(pts).to(dev),
            torch.from_numpy(alive).to(dev), torch.from_numpy(cam).to(dev))
    for tolerant in (True, False):
        before = kk.klt_bidir.launches
        pk, _, okk = kk.klt_bidir(*args, coarse_tolerant=tolerant)
        torch.cuda.synchronize()
        assert kk.klt_bidir.launches == before + 1
        pr, _, okr = kk.klt_bidir_reference(*args, coarse_tolerant=tolerant)
        assert torch.equal(okk, okr)
        both = okk & okr
        assert float((pk[both] - pr[both]).abs().max()) <= POS_TOL
