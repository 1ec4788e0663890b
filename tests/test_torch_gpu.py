"""Tests of the port that need a CUDA device; they skip without one.

This file imports neither JAX nor rsvio_tpu, so it runs on a GPU machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

(``--noconftest`` because the suite's conftest.py imports JAX.) The kernel
is compared with its plain PyTorch version on the same CUDA tensors: ``ok``
equal and positions within 1e-3 px, as in tests/test_torch_klt.py.
"""

import numpy as np
import pytest
import torch

from rsvio_tpu_torch.data import bench_scene
from rsvio_tpu_torch.models import estimator as est
from rsvio_tpu_torch.models.frontend import FrontendConfig
from rsvio_tpu_torch.ops import pyramid
from rsvio_tpu_torch.ops.cuda import klt_kernel as kk
from rsvio_tpu_torch.ops.klt import KLTConfig

POS_TOL = 1e-3
SHAPE = (72, 104)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _packed(dev, shifts, seed=0, levels=3):
    tex = bench_scene.make_texture(seed, size=512,
                                   octaves=((90.0, 24), (60.0, 96))).to(dev)
    imgs = [bench_scene.render(tex, dx, 0.2 * dx, shape=SHAPE, fx=120.0,
                               plane_z=3.0, scale=40.0, offset=200.0)
            for dx in shifts]
    return [kk.pack_pyramids([pyramid.build_pyramid(im, levels)])
            for im in imgs]


def _points(dev, n=64, seed=1):
    """Interior, border-band, outside, far-away and NaN positions."""
    rng = np.random.default_rng(seed)
    h, w = SHAPE
    pts = rng.uniform([4, 4], [w - 5, h - 5], size=(n, 2)).astype(np.float32)
    pts[:8] = [[-6.0, 20.0], [w + 4.0, 30.0], [1.2, 1.7], [w - 2.4, h - 2.2],
               [2.0, 35.0], [1e5, -1e5], [np.nan, 10.0], [np.inf, 5.0]]
    alive = np.ones(n, bool)
    alive[8:11] = False
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(alive).to(dev),
            torch.zeros(n, dtype=torch.int32, device=dev))


def _agree(a, b):
    pk, _, okk = a
    pr, _, okr = b
    assert torch.equal(okk, okr)
    assert float((pk[okk] - pr[okk]).abs().max()) <= POS_TOL
    # Failed features keep their (possibly non-finite) source position.
    assert torch.equal(torch.nan_to_num(pk[~okk]), torch.nan_to_num(pr[~okk]))


@pytest.mark.gpu
@pytest.mark.parametrize("tolerant,mode,lam", [
    (True, "lssd", 0.0), (False, "ssd", 0.5), (False, "lssd", 0.5)])
def test_kernel_matches_plain_version(dev, tolerant, mode, lam):
    (src, dims), (dst, _) = _packed(dev, [0.0, 0.017])
    pos, alive, cam = _points(dev)
    kw = dict(max_iterations=10, coarse_tolerant=tolerant,
              residual_mode=mode, lm_lambda=lam)
    out = kk.klt_bidir(src, dst, dims, pos, alive, cam, **kw)
    torch.cuda.synchronize()
    ref = kk.klt_bidir_reference(src, dst, dims, pos, alive, cam, **kw)
    _agree(out, ref)
    assert int(out[2].sum()) >= 30
    assert not out[2][[0, 1, 5, 6, 7]].any(), "outside / non-finite fail"
    assert not out[2][8:11].any(), "dead slots stay dead"


@pytest.mark.gpu
def test_launch_count_and_empty_batch(dev):
    (src, dims), (dst, _) = _packed(dev, [0.0, 0.01])
    pos, alive, cam = _points(dev, n=16)
    before = kk.klt_bidir.launches
    kk.klt_bidir(src, dst, dims, pos, alive, cam)
    kk.klt_bidir_reference(src, dst, dims, pos, alive, cam)
    assert kk.klt_bidir.launches == before + 1
    p, th, ok = kk.klt_bidir(src, dst, dims, pos[:0], alive[:0], cam[:0])
    torch.cuda.synchronize()
    assert p.shape == (0, 2) and ok.shape == (0,)


@pytest.mark.gpu
def test_wrapper_rejects_mixed_devices(dev):
    (src, dims), (dst, _) = _packed(dev, [0.0, 0.01])
    pos, alive, cam = _points(dev, n=8)
    with pytest.raises(ValueError):
        kk.klt_bidir(src, dst, dims, pos, alive.cpu(), cam)
    with pytest.raises(ValueError):
        kk.klt_bidir(src.cpu(), dst, dims, pos, alive, cam)


@pytest.mark.gpu
def test_step_on_cuda_matches_cpu(dev):
    """The whole step on a small scene: CUDA (kernel) vs CPU (plain)."""
    shape = (96, 128)
    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=32, cell_size=24, detect_margin=10,
                                klt=KLTConfig(levels=3, max_iterations=8)),
        window_size=4, image_shape=shape)
    tex = bench_scene.make_texture(1, size=768,
                                   octaves=((90.0, 24), (60.0, 96)))
    frames = bench_scene.stereo_frames(tex, 8, step_m=0.02, shape=shape,
                                       fx=100.0, plane_z=4.0, scale=60.0,
                                       offset=200.0)
    step = est.make_estimator_step(cfg)
    outs = {}
    for d in (torch.device("cpu"), dev):
        rig = bench_scene.make_rig(d, shape=shape, fx=100.0)
        state = est.init_state(cfg, device=d)
        outs[d.type] = []
        for a, b in frames:
            state, out = step(state, rig, a.to(d), b.to(d))
            outs[d.type].append(out)
    for oc, og in zip(outs["cpu"], outs["cuda"]):
        assert int(oc.n_tracked) == int(og.n_tracked)
        assert bool(oc.is_keyframe) == bool(og.is_keyframe)
        assert float((oc.T_W_B - og.T_W_B.cpu()).abs().max()) <= 1e-3
    assert float(outs["cuda"][-1].T_W_B[0, 3]) > 0.05
