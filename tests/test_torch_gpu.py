"""Tests of the port that need a CUDA device; they skip without one.

This file imports neither JAX nor rsvio_tpu, so it runs on a GPU machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

(``--noconftest`` because the suite's conftest.py imports JAX.) Each
kernel (``klt_bidir`` in both variants, ``klt_level`` in both variants) is
compared with its plain PyTorch version on the same CUDA tensors: ``ok``
equal, positions within 1e-3 px and angles within 1e-4 rad, as in
tests/test_torch_klt.py. The ``_points`` batches put features in the
border band, outside the image, far away and at NaN / inf, so the fused
kernel's tiles are staged there too (clamped, as the plain version's
windows); further cases cover, for both kernels, ragged batches,
interleaved cameras and a tile re-stage, and for ``klt_level`` non-finite
start angles.

The option paths of the shipped configs: the YAML loader without PyYAML
(this test needs no card), each shipped stereo config's rig on the card
equal to the CPU's, EUCM and radtan ``unproject`` and ``ransac_pnp_gate``
on CUDA against the CPU (1e-5 relative; the gate's mask, ok and count
equal), and the adaptive config's step on CUDA (kernel) against the CPU
(plain version) to the whole-step tolerance below.

The window options: ``marginalize_oldest`` / ``prior_terms`` /
``solve_ba_marginalized`` / ``refine_landmarks`` / ``reprojection_outliers``
/ ``scene_flow_gate`` on CUDA against the CPU (float32: priors within 1e-4
relative to max|H|, points within 1e-4 relative, masks and kill sets
equal; float64 results 1e-9, refined points 1e-7: a converged
Gauss-Newton step's keep-or-drop test compares costs at their rounding),
the step with every window option on CUDA
against the CPU, the marginalized step making as many host syncs per frame
as the default step (``torch.cuda.set_sync_debug_mode("warn")``), and one
``precision: f64`` config frame through the CUDA kernel (float32 inside
the kernel, float64 around it).

The command line: run_euroc on a tiny tree on the card against
``--device cpu`` (the whole-step tolerance, 2 K1 launches a frame), a CLI
frame making exactly one host sync beyond the step's own (the batched read;
the pinned upload adds none), the PNG reader's C++ unfilter built and held
to its numpy version wherever the file runs (this test needs no card), and
the checkpoint round trip on CUDA.

The distributed layer (rsvio_tpu_torch/parallel): the four sharded window
solvers on CUDA at world size 2 over gloo (both ranks on the card, spawned
by dryrun.run_ranks) against the single-device CUDA solves (poses within
1e-3 relative + 1e-4, priors' H within 5e-3 of max|H|, the ranks'
poses bitwise equal); NCCL at world size 1 (the group made in this
process) with one solve bitwise the single-device one; and the distributed
VO step making as many host syncs per frame as the single-device step
over NCCL, whose collectives add none.

The compiled step (make_compiled_estimator_step, CUDA graphs of the step's
segments) against the eager step over 30 frames of the small scene in the
default, marginalized and adaptive configs: flags equal, poses within
1e-5 m, 2 K1 launches a frame, one blocking read a frame (every call after
the first under ``set_sync_debug_mode("error")``); and the RANSAC vote's
exact tie of ROADMAP C4 going to the lower index on the card. The compiled
VIO step (make_compiled_vio_estimator_step) against the eager VIO step over
30 frames with the hover IMU buffer (FIFO, marginalized, RANSAC gate with
adaptive weights): poses within 1e-5 m, 2 K1 launches and one blocking read
a frame, and with the IMU buffer as CUDA tensors the same poses and one
more read a frame; the compiled mono step (make_compiled_mono_step)
against the eager pyramid build and step: the counts equal, no read.

The last eager paths on the compiled route: the compiled distributed steps
at world size 1 over NCCL in this process (VO, VO with marginalization,
VIO) against the eager distributed steps (poses within 1e-5 m, equal
collective counts, one read a frame); utils.graphs.compile_function on
solve_ba and solve_vio_ba against the eager calls; and the evaluation
harness without a probe (the compiled step) against the same call with a
probe (the eager step), positions within 1e-5 m. The harness's own host
syncs are counted around the compiled step it now takes.

The tracer (rsvio_tpu_torch.profiling) on the compiled VO and VIO steps:
the same poses bit for bit with recording on and off, one blocking read a
frame either way under set_sync_debug_mode("error"), and one positive
``graph.device`` record for each ``graph.replay``, from the timing events
the step records around its replays while the tracer is on.
"""

import contextlib
import glob
import os
import sys
import warnings

import numpy as np
import pytest
import torch

from rsvio_tpu_torch.data import bench_scene
from rsvio_tpu_torch.models import ba as ba_mod
from rsvio_tpu_torch.models import estimator as est
from rsvio_tpu_torch.models import marginalization as marg
from rsvio_tpu_torch.models import pnp as pnp_mod
from rsvio_tpu_torch.models.frontend import FrontendConfig
from rsvio_tpu_torch.ops import cameras, klt, lie, projection, pyramid
from rsvio_tpu_torch.ops.cuda import klt_kernel as kk
from rsvio_tpu_torch.ops.klt import KLTConfig
from rsvio_tpu_torch.utils import config as config_mod

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks  # noqa: E402

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config")

POS_TOL = 1e-3
THETA_TOL = 1e-4
SHAPE = (72, 104)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pyramids(dev, shifts, seed=0, levels=3, roll=0.0):
    """Pyramids of renders at x offsets `shifts`; all but the first rolled
    by `roll` rad."""
    tex = bench_scene.make_texture(seed, size=512,
                                   octaves=((90.0, 24), (60.0, 96))).to(dev)
    return [pyramid.build_pyramid(
        bench_scene.render(tex, dx, 0.2 * dx, shape=SHAPE, fx=120.0,
                           plane_z=3.0, scale=40.0, offset=200.0,
                           roll=roll if k else 0.0), levels)
        for k, dx in enumerate(shifts)]


def _packed(dev, shifts, seed=0, levels=3, roll=0.0):
    return [kk.pack_pyramids([p])
            for p in _pyramids(dev, shifts, seed, levels, roll)]


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


def _same(a, b):
    """Equal values, NaN where NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _agree(a, b, failed_keep_source=True):
    pk, thk, okk = a
    pr, thr, okr = b
    assert torch.equal(okk, okr)
    assert float((pk[okk] - pr[okk]).abs().max()) <= POS_TOL
    assert float((thk[okk] - thr[okk]).abs().max()) <= THETA_TOL
    if failed_keep_source:
        # Failed features keep their (possibly non-finite) source position.
        assert torch.equal(torch.nan_to_num(pk[~okk]),
                           torch.nan_to_num(pr[~okk]))


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
@pytest.mark.parametrize("tolerant,mode,lam", [
    (True, "lssd", 0.0), (False, "ssd", 0.5)])
def test_rotation_kernel_matches_plain_version(dev, tolerant, mode, lam):
    """K1-rot on a pair rolled by 0.05 rad (2.9 deg)."""
    (src, dims), (dst, _) = _packed(dev, [0.0, 0.01], roll=0.05)
    pos, alive, cam = _points(dev)
    kw = dict(max_iterations=10, coarse_tolerant=tolerant,
              residual_mode=mode, lm_lambda=lam, with_rotation=True)
    before = (kk.klt_bidir.launches, kk.klt_bidir.rot_launches)
    out = kk.klt_bidir(src, dst, dims, pos, alive, cam, **kw)
    torch.cuda.synchronize()
    assert (kk.klt_bidir.launches, kk.klt_bidir.rot_launches) == (
        before[0], before[1] + 1)
    ref = kk.klt_bidir_reference(src, dst, dims, pos, alive, cam, **kw)
    _agree(out, ref)
    assert int(out[2].sum()) >= 20
    assert float(out[1][out[2]].mean()) < -0.03, "the roll is recovered"


@pytest.mark.gpu
@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("n", [1, 37])
def test_kernel_ragged_batch_two_cameras(dev, rot, n):
    """K1 / K1-rot with N = 1 and N = 37 (not a multiple of the features
    per block) on two cameras whose features interleave (cam 0, 1, 0, ...),
    each tracking in its own images."""
    roll = 0.05 if rot else 0.0
    (a0, dims), (a1, _) = _packed(dev, [0.0, 0.012], seed=3, roll=roll)
    (b0, _), (b1, _) = _packed(dev, [0.0, -0.02], seed=4, roll=roll)
    src = torch.cat([a0, b0]).contiguous()
    dst = torch.cat([a1, b1]).contiguous()
    pos, alive, _ = _points(dev, n=37, seed=5)
    pos, alive = pos[-n:].contiguous(), alive[-n:].contiguous()
    cam = (torch.arange(n, device=dev) % 2).to(torch.int32)
    kw = dict(max_iterations=10, coarse_tolerant=True, with_rotation=rot)
    out = kk.klt_bidir(src, dst, dims, pos, alive, cam, **kw)
    torch.cuda.synchronize()
    ref = kk.klt_bidir_reference(src, dst, dims, pos, alive, cam, **kw)
    _agree(out, ref)
    assert int(out[2].sum()) >= (1 if n == 1 else 20)


@pytest.mark.gpu
@pytest.mark.parametrize("rot", [False, True])
def test_kernel_restages_its_tile(dev, rot):
    """One level and a shift of (-8, -1.6) px: Gauss-Newton travels beyond
    the slack of the tile staged at the start position, so the kernel
    re-stages it around the iterate and must still match the plain
    version."""
    (src, dims), (dst, _) = _packed(dev, [0.0, 0.2], levels=1)
    pos, alive, cam = _points(dev)
    kw = dict(with_rotation=rot)
    out = kk.klt_bidir(src, dst, dims, pos, alive, cam, **kw)
    torch.cuda.synchronize()
    work = {"templates": 0, "iterations": 0}
    ref = kk.klt_bidir_reference(src, dst, dims, pos, alive, cam, work=work,
                                 **kw)
    # A feature that fails only on the way back keeps its forward result,
    # which differs from the plain version's by rounding.
    _agree(out, ref, failed_keep_source=False)
    fail = ~out[2] & torch.isfinite(ref[0]).all(dim=1)
    assert float((out[0][fail] - ref[0][fail]).abs().max()) <= POS_TOL
    # The tile is staged at floor(p) - 15 and holds a step's support while
    # floor(iterate) - floor(p) lies in [-7, 8] on both axes (rotation: a
    # narrower range); a step from outside that range re-stages it. An ok
    # track with a chain of <= 21 links took <= 19 forward steps, so it
    # converged and its last step moved it < 0.01 px: if its result lies
    # beyond the range by more, that step started outside it.
    conv = ref[2] & (work["chain"] <= 21)
    low = torch.floor(ref[0] + 0.01) - torch.floor(pos) <= -8
    high = torch.floor(ref[0] - 0.01) - torch.floor(pos) >= 9
    restaged = conv & (low | high).any(dim=1)
    assert int(restaged.sum()) >= 10, "too few tracks left the first tile"


@pytest.mark.gpu
@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("lvl", [0, 2])
def test_level_kernel_matches_plain_version(dev, rot, lvl):
    """K2 at one level, from perturbed start positions and angles (inside
    the theta gate), and from a start angle far outside it."""
    p0, p1 = _pyramids(dev, [0.0, 0.01], roll=0.05 if rot else 0.0)
    src, dst = p0[lvl][None].contiguous(), p1[lvl][None].contiguous()
    pos, alive, cam = _points(dev)
    pos = pos / 2.0 ** lvl
    gen = torch.Generator().manual_seed(lvl)
    start = (pos + torch.randn(pos.shape, generator=gen).to(dev) * 0.4)
    theta0 = (torch.rand(pos.shape[0], generator=gen) * 0.4 - 0.2).to(dev)
    theta0[-4:] = 2.5          # beyond the gate: sampling stays exact
    for mode in ("lssd", "ssd"):
        kw = dict(max_iterations=10, residual_mode=mode, with_rotation=rot)
        args = (src, dst, pos, start.contiguous(), theta0, alive, cam)
        before = kk.klt_level.launches
        out = kk.klt_level(*args, **kw)
        torch.cuda.synchronize()
        assert kk.klt_level.launches == before + 1
        ref = kk.klt_level_reference(*args, **kw)
        # A failed level keeps its last Gauss-Newton position, which is not
        # compared; a dead feature keeps its start exactly.
        _agree(out, ref, failed_keep_source=False)
        dead = ~alive
        assert torch.equal(out[0][dead], start[dead])
        assert torch.equal(out[1][dead], theta0[dead])
        assert int(out[2].sum()) >= 15


def _level_stacks(dev, lvl, rot, levels=3, shifts=(0.012, -0.02)):
    """Level `lvl` of two cameras' image pairs (seeds 3 and 4; camera k's
    second image at x offset shifts[k], rolled by 0.05 rad with rotation)
    as (2, h, w) src and dst stacks."""
    pairs = [_pyramids(dev, [0.0, dx], seed=seed, levels=levels,
                       roll=0.05 if rot else 0.0)
             for seed, dx in zip((3, 4), shifts)]
    return (torch.stack([p[0][lvl] for p in pairs]).contiguous(),
            torch.stack([p[1][lvl] for p in pairs]).contiguous())


def _level_starts(dev, pos, rot, seed):
    """Start positions 0.4 px (sd) off `pos` and, with rotation, start
    angles in [-0.2, 0.2) rad."""
    gen = torch.Generator().manual_seed(seed)
    start = pos + torch.randn(pos.shape, generator=gen).to(dev) * 0.4
    theta0 = (torch.rand(pos.shape[0], generator=gen) * 0.4 - 0.2).to(dev)
    return start.contiguous(), theta0 if rot else torch.zeros_like(theta0)


@pytest.mark.gpu
@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("n", [1, 37])
def test_level_kernel_ragged_batch_two_cameras(dev, rot, n):
    """K2 / K2-rot with N = 1 and N = 37 (not a multiple of the features
    per block) on two cameras whose features interleave (cam 0, 1, 0, ...),
    each tracking in its own images."""
    src, dst = _level_stacks(dev, 1, rot)
    pos, alive, _ = _points(dev, n=37, seed=5)
    pos, alive = (pos[-n:] / 2.0).contiguous(), alive[-n:].contiguous()
    cam = (torch.arange(n, device=dev) % 2).to(torch.int32)
    start, theta0 = _level_starts(dev, pos, rot, seed=6)
    args = (src, dst, pos, start, theta0, alive, cam)
    kw = dict(max_iterations=10, with_rotation=rot)
    out = kk.klt_level(*args, **kw)
    torch.cuda.synchronize()
    ref = kk.klt_level_reference(*args, **kw)
    _agree(out, ref, failed_keep_source=False)
    dead = ~alive
    assert torch.equal(out[0][dead], start[dead])
    assert torch.equal(out[1][dead], theta0[dead])
    assert int(out[2].sum()) >= (1 if n == 1 else 20)


@pytest.mark.gpu
@pytest.mark.parametrize("rot", [False, True])
def test_level_kernel_restages_its_tile(dev, rot):
    """One level, a shift of (-8, -1.6) px and starts 1.5 px the other way
    along x: Gauss-Newton travels ~9.5 px, beyond the slack of the tile
    staged at the start, so the kernel re-stages it around the iterate and
    must still match the plain version."""
    p0, p1 = _pyramids(dev, [0.0, 0.2], levels=1)
    src, dst = p0[0][None].contiguous(), p1[0][None].contiguous()
    pos, alive, cam = _points(dev)
    start = (pos + torch.tensor([1.5, 0.0], device=dev)).contiguous()
    theta0 = torch.zeros(pos.shape[0], device=dev)
    args = (src, dst, pos, start, theta0, alive, cam)
    kw = dict(max_iterations=30, with_rotation=rot)
    out = kk.klt_level(*args, **kw)
    torch.cuda.synchronize()
    work = {"templates": 0, "iterations": 0}
    ref = kk.klt_level_reference(*args, work=work, **kw)
    # An ok track with a chain of <= 30 links took <= 29 of its 30 steps, so
    # it converged and its last step moved it < 0.01 px. One that used all
    # 30 steps oscillates (here, between minima ~10 px apart) and amplifies
    # rounding, so only converged tracks are held to the position
    # tolerance; ok is compared on every row.
    conv = ref[2] & (work["chain"] <= 30)
    assert torch.equal(out[2], ref[2])
    _agree(tuple(t[conv] for t in out), tuple(t[conv] for t in ref),
           failed_keep_source=False)
    # The tile is staged at floor(start) - 15 and holds a step's support
    # while floor(iterate) - floor(start) lies in [-7, 8] on both axes
    # (rotation: a narrower range); a step from outside that range
    # re-stages it. If a converged track's result lies beyond the range by
    # more than 0.01 px, its last step started outside it.
    low = torch.floor(ref[0] + 0.01) - torch.floor(start) <= -8
    high = torch.floor(ref[0] - 0.01) - torch.floor(start) >= 9
    restaged = conv & (low | high).any(dim=1)
    assert int(restaged.sum()) >= 10, "too few tracks left the first tile"


@pytest.mark.gpu
@pytest.mark.parametrize("rot", [False, True])
def test_level_kernel_non_finite_theta0(dev, rot):
    """Start angles NaN, +inf and -inf. With rotation such a row takes no
    step and fails: no fault, ok = 0, pos_dst0 and its angle returned bit
    for bit (its taps are read with bounds checks, not from the tile). The
    translation variant ignores the angle and returns it. Every other row
    gets what it gets in a run without those rows."""
    src, dst = _level_stacks(dev, 1, rot)
    pos, alive, _ = _points(dev, n=37, seed=5)
    pos = (pos / 2.0).contiguous()
    cam = (torch.arange(37, device=dev) % 2).to(torch.int32)
    start, theta0 = _level_starts(dev, pos, rot, seed=6)
    bad = torch.tensor([12, 20, 30], device=dev)
    theta0[bad] = torch.tensor([float("nan"), float("inf"), -float("inf")],
                               device=dev)
    good = torch.ones(37, dtype=torch.bool, device=dev)
    good[bad] = False
    kw = dict(max_iterations=10, with_rotation=rot)

    def run(rows, th):
        return kk.klt_level(src, dst, pos[rows].contiguous(),
                            start[rows].contiguous(), th[rows].contiguous(),
                            alive[rows].contiguous(), cam[rows].contiguous(),
                            **kw)

    p, th, ok = run(torch.arange(37, device=dev), theta0)
    torch.cuda.synchronize()
    assert bool(alive[bad].all())
    for a, b in zip((p, th, ok), run(good, theta0)):
        _same(a[good], b)
    assert int(ok[good].sum()) >= 20
    _same(th[bad], theta0[bad])
    if rot:
        assert not ok[bad].any()
        _same(p[bad], start[bad])
    else:
        p_0, _, ok_0 = run(bad, torch.zeros_like(theta0))
        _same(p[bad], p_0)
        _same(ok[bad], ok_0)
    rp, rth, rok = kk.klt_level_reference(src, dst, pos, start, theta0,
                                          alive, cam, **kw)
    _agree((p, torch.nan_to_num(th), ok), (rp, torch.nan_to_num(rth), rok),
           failed_keep_source=False)


@pytest.mark.gpu
@pytest.mark.parametrize("rot", [False, True])
def test_track_points_launches_once_per_level(dev, rot):
    """track_points on the kernel route: one K2 launch per level, and the
    forward + backward composition agrees with one fused K1 launch."""
    levels = 3
    p0, p1 = _pyramids(dev, [0.0, 0.01], levels=levels,
                       roll=0.03 if rot else 0.0)
    pos, alive, _ = _points(dev)
    pos, alive = pos[8:], alive[8:]
    cfg = KLTConfig(levels=levels, max_iterations=10, track_rotation=rot)
    n = pos.shape[0]
    eye = torch.eye(2, device=dev).expand(n, 2, 2)
    before = kk.klt_level.launches
    pf, Af, okf = klt.track_points(p0, p1, pos, pos, eye, alive, cfg)
    pb, _, okb = klt.track_points(p1, p0, pf, pos, Af.transpose(-1, -2), okf,
                                  cfg)
    torch.cuda.synchronize()
    assert kk.klt_level.launches == before + 2 * levels
    ok = okf & okb & (((pb - pos) ** 2).sum(dim=1) < cfg.bidir_threshold_sq)
    p, A, ok1 = klt.track_points_bidirectional(p0, p1, pos, alive, cfg)
    assert float((ok == ok1).float().mean()) >= 0.99
    both = ok & ok1
    assert float((p[both] - pf[both]).abs().max()) <= POS_TOL
    assert float((A[both] - Af[both]).abs().max()) <= THETA_TOL
    assert int(both.sum()) >= 20


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
    h, w = dims[0]
    img = src[:, :h * w].reshape(1, h, w)
    p, th, ok = kk.klt_level(img, img, pos[:0], pos[:0], th, alive[:0],
                             cam[:0], with_rotation=True)
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


def test_config_loader_needs_no_pyyaml(monkeypatch):
    """Every shipped config loads with PyYAML unimportable."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    paths = sorted(glob.glob(os.path.join(CONFIG_DIR, "*.yaml")))
    assert len(paths) == 6
    for p in paths:
        cfg = config_mod.load_config(p)
        assert cfg.camera.image_width > 0
    cfg = config_mod.load_config(os.path.join(CONFIG_DIR, "tum_vi.yaml"))
    assert cfg.camera.left_model == "EUCM"
    assert cfg.camera.left_distortion == [0.6246288732884442,
                                          1.0598071085569876]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["euroc_vio", "euroc_vo_dynamic",
                                  "euroc_vo_adaptive", "4seasons", "tum_vi"])
def test_config_rig_on_cuda_equals_cpu(dev, name):
    cfg = config_mod.load_config(os.path.join(CONFIG_DIR, name + ".yaml"))
    ecfg_g, rig_g = config_mod.make_estimator_config(cfg, device=dev)
    ecfg_c, rig_c = config_mod.make_estimator_config(cfg, device="cpu")
    assert ecfg_g == ecfg_c
    for a, b in zip(rig_g, rig_c):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,intr,dist", [
    ("EUCM", [191.7556, 191.7482, 254.9226, 256.8780], [0.6246, 1.0598]),
    ("pinhole-radtan", [458.654, 457.296, 367.215, 248.375],
     [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])])
def test_unproject_on_cuda_matches_cpu(dev, kind, intr, dist):
    p = cameras.pack_params(kind, intr, dist, device="cpu")
    g = torch.arange(-8.0, 760.0, 6.0)
    uv = torch.stack(torch.meshgrid(g, g[:90], indexing="xy"),
                     dim=-1).reshape(-1, 2)
    xy_c = cameras.unproject(kind, p, uv)
    xy_g = cameras.unproject(kind, p.to(dev), uv.to(dev))
    assert xy_g.is_cuda
    torch.testing.assert_close(xy_g.cpu(), xy_c, rtol=1e-5, atol=1e-6)
    pts = torch.cat([xy_c, torch.ones_like(xy_c[:, :1])], dim=1)
    uv_c, ok_c = cameras.project(kind, p, pts)
    uv_g, ok_g = cameras.project(kind, p.to(dev), pts.to(dev))
    assert torch.equal(ok_g.cpu(), ok_c)
    torch.testing.assert_close(uv_g.cpu(), uv_c, rtol=1e-5, atol=1e-3)


def _gate_problem(seed=3, n=48):
    """A stereo PnP problem with a coherent group of 30 % outliers."""
    gen = torch.Generator().manual_seed(seed)
    T_C_B = torch.eye(4).repeat(2, 1, 1)
    T_C_B[1, 0, 3] = -0.11
    T_W_B = lie.se3_exp(torch.tensor([0.1, -0.05, 0.2, 0.02, -0.03, 0.01]))
    p_B = torch.rand((n, 3), generator=gen) * torch.tensor([3.0, 2.0, 4.0]) \
        + torch.tensor([-1.5, -1.0, 2.0])
    p_W = p_B @ T_W_B[:3, :3].T + T_W_B[:3, 3]
    p_C = p_B[None] + T_C_B[:, None, :3, 3]
    obs = p_C[..., :2] / p_C[..., 2:]
    obs[:, torch.arange(n) % 10 < 3] += torch.tensor([0.06, -0.03])
    mask = torch.ones((2, n), dtype=torch.bool)
    T_init = T_W_B @ lie.se3_exp(torch.tensor([0.02, 0.01, -0.02, 0.01,
                                               0.0, -0.01]))
    age = torch.randint(0, 25, (n,), generator=gen, dtype=torch.int32)
    gumbel = -torch.log(torch.empty((16, 2 * n)).exponential_(generator=gen))
    return T_init, T_C_B, p_W, obs, mask, gumbel, age


@pytest.mark.gpu
def test_ransac_gate_on_cuda_matches_cpu(dev):
    args = _gate_problem()
    cfg = pnp_mod.PnPConfig(ransac_hypotheses=16)
    inl_c, ok_c, n_c = pnp_mod.ransac_pnp_gate(*args[:-1], cfg, age=args[-1])
    inl_g, ok_g, n_g = pnp_mod.ransac_pnp_gate(
        *(a.to(dev) for a in args[:-1]), cfg, age=args[-1].to(dev))
    assert inl_g.is_cuda
    assert torch.equal(inl_g.cpu(), inl_c)
    assert bool(ok_g) == bool(ok_c) is True
    assert int(n_g) == int(n_c)
    assert not inl_c[:, torch.arange(48) % 10 < 3].any()


C4_GATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "c4_gate_frame19.npz")


@pytest.mark.gpu
def test_ransac_exact_vote_tie_on_cuda(dev):
    """C4 (ROADMAP): the frame-19 gate inputs of occlusion_6dof x vo_adapt
    (tests/test_torch_options.py) on the card in float64: two hypotheses'
    integer votes tie and the gate takes the lower index, the CPU's pick."""
    d = np.load(C4_GATE)
    arrays = [torch.from_numpy(d[k]) for k in (
        "T_W_B_init", "T_C_B", "landmarks", "obs", "mask", "gumbel")]
    age = torch.from_numpy(d["age"])
    cfg = pnp_mod.PnPConfig(**{f: type(v)(d[f]) for f, v in
                               pnp_mod.PnPConfig()._asdict().items()})
    inl = pnp_mod.ransac_hypotheses(*(a.to(dev) for a in arrays), cfg,
                                    age=age.to(dev))[0].cpu().numpy()
    w = np.clip(d["age"].astype(np.int64), 1, cfg.ransac_age_cap)
    votes = (inl.astype(np.int64) * w[None, None, :]).sum(axis=(1, 2))
    top = np.flatnonzero(votes == votes.max())
    assert len(top) >= 2
    inl_g, ok_g, n_g = pnp_mod.ransac_pnp_gate(
        *(a.to(dev) for a in arrays), cfg, age=age.to(dev))
    inl_c, ok_c, n_c = pnp_mod.ransac_pnp_gate(*arrays, cfg, age=age)
    np.testing.assert_array_equal(inl_g.cpu().numpy(), inl[top[0]])
    assert torch.equal(inl_g.cpu(), inl_c)
    assert int(n_g) == int(n_c) == 409 and bool(ok_g) and bool(ok_c)


@pytest.mark.gpu
def test_adaptive_step_on_cuda_matches_cpu(dev):
    """The adaptive config's options (score weights, starvation floor,
    RANSAC gate with its draws, adaptive prior and vision weights, health
    hysteresis) through the whole step: CUDA (kernel) vs CPU (plain)."""
    shape = (96, 128)
    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=32, cell_size=24, detect_margin=10,
                                relax_floor_below=16,
                                klt=KLTConfig(levels=3, max_iterations=8)),
        window_size=4, image_shape=shape, use_obs_weights=True,
        pnp=pnp_mod.PnPConfig(ransac_hypotheses=8, motion_prior_weight=20.0),
        pnp_prior_adaptive=True, vision_weight_adaptive=True,
        health_recover=0.5, health_f_lo=0.9, health_f_hi=1.1)
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
        for f in ("n_tracked", "is_keyframe", "n_ransac_inliers",
                  "n_pnp_candidates"):
            assert int(getattr(oc, f)) == int(getattr(og, f)), f
        assert float((oc.T_W_B - og.T_W_B.cpu()).abs().max()) <= 1e-3
        assert abs(float(oc.health) - float(og.health)) <= 1e-4
    assert float(outs["cuda"][-1].T_W_B[0, 3]) > 0.05
    assert any(int(o.n_ransac_inliers) >= 12 for o in outs["cuda"])


# --------------------------------------------------------------------------
# The window options (marginalization, culling, refinement, flow gate)
# --------------------------------------------------------------------------

def _window_problem(dtype, seed=5, w=5, n=40):
    """A stereo window: poses 0.3 m apart, landmarks 3-8 m ahead seen in
    every frame, ~1 px noise; the initial poses and points perturbed."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    T_C_B = torch.eye(4, dtype=torch.float64).repeat(2, 1, 1)
    T_C_B[1, 0, 3] = -0.11
    T_gt = lie.se3_exp(torch.cat([torch.stack([
        torch.tensor([0.3 * i, 0.02 * i, 0.0], dtype=torch.float64)
        for i in range(w)]), rnd(w, 3) * 0.05], dim=1))
    p_W = torch.rand((n, 3), generator=gen, dtype=torch.float64) \
        * torch.tensor([6.0, 4.0, 5.0], dtype=torch.float64) \
        + torch.tensor([-2.0, -2.0, 3.0], dtype=torch.float64)
    T_B_W = lie.se3_inverse(T_gt)
    p_B = (T_B_W[:, None, :3, :3] @ p_W[None, :, :, None])[..., 0] \
        + T_B_W[:, None, :3, 3]
    p_C = p_B[:, None] + T_C_B[None, :, None, :3, 3]
    obs = p_C[..., :2] / p_C[..., 2:] + rnd(w, 2, n, 2) * 2e-3
    mask = p_C[..., 2] > 0.5
    T_init = T_gt @ lie.se3_exp(torch.cat([torch.zeros(1, 6,
                                                       dtype=torch.float64),
                                           rnd(w - 1, 6) * 0.01]))
    lms = p_W + rnd(n, 3) * 0.05
    return [x.to(dtype) for x in (T_init, T_C_B, lms, obs)] + [
        mask, torch.ones(n, dtype=torch.bool)]


def _close(a, b, rel, scale=None):
    if a.dtype == torch.bool or not a.is_floating_point():
        assert torch.equal(a.cpu(), b), (a, b)
        return
    s = float(b.abs().max()) if scale is None else scale
    torch.testing.assert_close(a.cpu(), b, rtol=0,
                               atol=rel * max(s, 1.0), equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fn", ["marginalize_oldest", "solve_ba_marginalized",
                                "refine_landmarks", "reprojection_outliers",
                                "scene_flow_gate"])
def test_window_functions_on_cuda_match_cpu(dev, fn, dtype):
    rel = 1e-4 if dtype == torch.float32 else 1e-9
    T_init, T_C_B, lms, obs, mask, lm_valid = _window_problem(dtype)
    W = T_init.shape[0]

    def both(f, *args):
        cpu = f(*args)
        gpu = f(*(a.to(dev) if torch.is_tensor(a) else a for a in args))
        return cpu, gpu

    if fn == "marginalize_oldest":
        gen = torch.Generator().manual_seed(0)
        A = torch.randn((W * 6, W * 6), generator=gen, dtype=torch.float64)
        H = (A @ A.T + 0.1 * torch.eye(W * 6, dtype=torch.float64)).to(dtype)
        g = torch.randn(W * 6, generator=gen, dtype=torch.float64).to(dtype)
        pc, pg = both(lambda *a: marg.marginalize_oldest(
            *a, marg.empty_prior(W, 6, dtype, a[0].device), 6),
            H, g, T_init, torch.zeros((W, 0), dtype=dtype))
        scale = float(pc.H.abs().max())
        for a, b in zip(pg, pc):
            _close(a, b, rel, scale)
        tc = marg.prior_terms(pc, T_init, torch.zeros((W, 0), dtype=dtype))
        tg = marg.prior_terms(marg.MargPrior(*(x.to(dev) for x in pc)),
                              T_init.to(dev), torch.zeros((W, 0), dtype=dtype,
                                                          device=dev))
        for a, b in zip(tg, tc):
            _close(a, b, rel, scale)
    elif fn == "solve_ba_marginalized":
        args = (T_init, T_C_B, lms, obs, mask, lm_valid)
        rc, pc = ba_mod.solve_ba_marginalized(
            *args, marg.empty_prior(W, 6, dtype, "cpu"), torch.tensor(True))
        rg, pg = ba_mod.solve_ba_marginalized(
            *(a.to(dev) for a in args), marg.empty_prior(W, 6, dtype, dev),
            torch.tensor(True, device=dev))
        assert bool(rc.success) and bool(rg.success) and bool(pg.valid)
        _close(rg.T_W_B, rc.T_W_B, 1e-4 if dtype == torch.float32 else 1e-6)
        scale = float(pc.H.abs().max())
        for a, b in zip(pg, pc):
            _close(a, b, rel if dtype == torch.float64 else 1e-3, scale)
        # The next solve on the rolled window (oldest dropped, newest
        # repeated), anchored by each side's prior: no pose is fixed.
        def roll(a):
            return torch.cat([a[1:], a[-1:]])

        rc2, _ = ba_mod.solve_ba_marginalized(
            roll(rc.T_W_B), T_C_B, rc.landmarks, roll(obs), roll(mask),
            lm_valid, pc, torch.tensor(False))
        rg2, _ = ba_mod.solve_ba_marginalized(
            roll(rg.T_W_B), T_C_B.to(dev), rg.landmarks, roll(obs).to(dev),
            roll(mask).to(dev), lm_valid.to(dev), pg,
            torch.tensor(False, device=dev))
        assert bool(rc2.success) == bool(rg2.success) is True
        _close(rg2.T_W_B, rc2.T_W_B, 1e-4 if dtype == torch.float32 else 1e-6)
    elif fn == "refine_landmarks":
        (pc, okc), (pg, okg) = both(
            projection.refine_landmarks, T_C_B, lie.se3_inverse(T_init),
            lms, obs, mask)
        assert torch.equal(okg.cpu(), okc) and bool(okc.any())
        # Each Gauss-Newton step is kept where it does not raise the cost;
        # once converged that test compares costs at their rounding, which
        # the two devices' sums reach in another order, so a last step of
        # ~4e-8 m (measured, float64) can be kept on one and not the other.
        _close(pg, pc, 1e-4 if dtype == torch.float32 else 1e-7)
    elif fn == "reprojection_outliers":
        bad_lms = lms.clone()
        bad_lms[3] += torch.tensor([1.0, 0.0, 0.0], dtype=dtype)
        bc, bg = both(est.reprojection_outliers, T_C_B, T_init, bad_lms, obs,
                      mask, lm_valid, 0.02 ** 2)
        assert torch.equal(bg.cpu(), bc) and bool(bc[3])
    else:
        n = lms.shape[0]
        cfg = est.EstimatorConfig(dynamic_flow_thresh=0.02)
        rig = bench_scene.make_rig("cpu", shape=SHAPE, fx=120.0)
        rig = est.CameraRig(*(x.to(dtype) for x in rig))
        table = est.init_table(n, dtype, "cpu")._replace(
            alive=torch.ones(n, dtype=torch.bool),
            fid=torch.arange(n, dtype=torch.int32))
        tri = lms.clone()
        tri[:6, 0] += 0.1 * tri[:6, 2]               # six movers
        obs_cur = torch.stack([tri[:, :2] / tri[:, 2:],
                               (tri[:, :2] - torch.tensor(
                                   [0.11, 0.0], dtype=dtype)) / tri[:, 2:]])
        mem = (lms, table.fid, torch.zeros((n, 2), dtype=dtype),
               torch.full((n,), 1, dtype=torch.int32))
        T = torch.eye(4, dtype=dtype)
        m = torch.ones((2, n), dtype=torch.bool)
        ok = torch.ones(n, dtype=torch.bool)
        kc, memc, nc = est.scene_flow_gate(cfg, rig, T, obs_cur, m, table,
                                           tri, ok, *mem)
        kg, memg, ng = est.scene_flow_gate(
            cfg, est.CameraRig(*(x.to(dev) for x in rig)), T.to(dev),
            obs_cur.to(dev), m.to(dev), est.FeatureTable(
                *(x.to(dev) for x in table)), tri.to(dev), ok.to(dev),
            *(x.to(dev) for x in mem))
        assert torch.equal(kg.cpu(), kc) and int(ng) == int(nc)
        assert bool(kc[:6].all()) and not bool(kc[6:].any())
        for a, b in zip(memg, memc):
            _close(a, b, rel)


def _small_scene(n=8):
    shape = (96, 128)
    tex = bench_scene.make_texture(1, size=768,
                                   octaves=((90.0, 24), (60.0, 96)))
    frames = bench_scene.stereo_frames(tex, n, step_m=0.02, shape=shape,
                                       fx=100.0, plane_z=4.0, scale=60.0,
                                       offset=200.0)
    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=32, cell_size=24, detect_margin=10,
                                klt=KLTConfig(levels=3, max_iterations=8)),
        window_size=4, image_shape=shape)
    return cfg, frames, shape


@pytest.mark.gpu
def test_window_options_step_on_cuda_matches_cpu(dev):
    """Every window option at once through the whole step: CUDA (kernel)
    vs CPU (plain), with the option counts equal."""
    base, frames, shape = _small_scene(10)
    cfg = base._replace(use_marginalization=True, refine_births=True,
                        cull_reproj_threshold=3e-4, pnp_cv_predict=True,
                        dynamic_flow_thresh=1e-3)
    outs, probes = {}, {}
    for d in (torch.device("cpu"), dev):
        probe = {}
        step = est.make_estimator_step(cfg, probe=probe)
        rig = bench_scene.make_rig(d, shape=shape, fx=100.0)
        state = est.init_state(cfg, device=d)
        outs[d.type] = []
        for a, b in frames:
            state, out = step(state, rig, a.to(d), b.to(d))
            outs[d.type].append(out)
        probes[d.type] = {k: int(v) for k, v in probe.items()}
        assert bool(state.marg_prior.valid)
    assert probes["cpu"] == probes["cuda"]
    assert probes["cuda"]["priors_made"] >= 2
    assert probes["cuda"]["refined"] > 0 and probes["cuda"]["cv_seeded"] > 0
    for oc, og in zip(outs["cpu"], outs["cuda"]):
        for f in ("n_tracked", "is_keyframe", "ba_success", "n_dyn_killed"):
            assert int(getattr(oc, f)) == int(getattr(og, f)), f
        assert float((oc.T_W_B - og.T_W_B.cpu()).abs().max()) <= 1e-3
    assert float(outs["cuda"][-1].T_W_B[0, 3]) > 0.05


@pytest.mark.gpu
def test_marginalized_step_adds_no_host_sync(dev):
    """Host syncs per frame, as torch's sync debug mode reports them (a
    device-to-host read, and also a host scalar copied to the card): the
    marginalized step (prior terms, gauge select, prior update, all on the
    device) makes exactly as many as the default step on frames of the same
    kind. Each config's sequence runs twice and the second pass is counted,
    so lazy initialization on first use is not."""
    base, frames, shape = _small_scene(10)
    rig = bench_scene.make_rig(dev, shape=shape, fx=100.0)
    frames_d = [(a.to(dev), b.to(dev)) for a, b in frames]
    per_kind, where = {}, {}
    for name, cfg in (("default", base),
                      ("marg", base._replace(use_marginalization=True))):
        step = est.make_estimator_step(cfg)
        for counted in (False, True):
            state = est.init_state(cfg, device=dev)
            torch.cuda.synchronize()
            for a, b in frames_d:
                with warnings.catch_warnings(record=True) as rec:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        state, out = step(state, rig, a, b)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                syncs = [f"{os.path.basename(w.filename)}:{w.lineno}"
                         for w in rec if "synchroniz" in str(w.message)]
                if counted:
                    key = (bool(out.is_keyframe), bool(out.ba_success))
                    per_kind.setdefault(name, {}).setdefault(
                        key, set()).add(len(syncs))
                    where.setdefault((name, key), syncs)
        if name == "marg":
            assert bool(state.marg_prior.valid)
    assert per_kind["marg"].get((True, True))
    for key, counts in per_kind["marg"].items():
        if key in per_kind["default"]:
            assert counts == per_kind["default"][key], (
                key, per_kind, where[("default", key)], where[("marg", key)])


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [
    dict(), dict(use_marginalization=True),
    dict(use_obs_weights=True, pnp_prior_adaptive=True,
         vision_weight_adaptive=True)],
    ids=["default", "marg", "adaptive"])
def test_compiled_step_on_cuda_matches_eager(dev, opts):
    """make_compiled_estimator_step on the card (CUDA graphs) against the
    eager step over 30 frames: flags and counts equal, poses within 1e-5 m
    (the same kernels in the same order), exactly 2 K1 launches a frame,
    and one blocking read a frame: every call after the first runs under
    torch.cuda.set_sync_debug_mode("error") and waits once for is_kf."""
    base, frames, shape = _small_scene(30)
    pnp = base.pnp
    if opts.get("pnp_prior_adaptive"):
        pnp = pnp._replace(ransac_hypotheses=16, motion_prior_weight=20.0)
    cfg = base._replace(pnp=pnp, **opts)
    rig = bench_scene.make_rig(dev, shape=shape, fx=100.0)
    frames_d = [(a.to(dev), b.to(dev)) for a, b in frames]
    outs = {}
    for name in ("eager", "compiled"):
        step = (est.make_compiled_estimator_step(cfg, device=dev)
                if name == "compiled" else est.make_estimator_step(cfg))
        state = est.init_state(cfg, device=dev)
        torch.cuda.synchronize()
        kk.klt_bidir.launches = 0
        outs[name] = []
        for k, (a, b) in enumerate(frames_d):
            if name == "compiled" and k > 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, out = step(state, rig, a, b)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            outs[name].append(est.FrameOutput(*(t.clone() for t in out)))
        assert kk.klt_bidir.launches == 2 * len(frames)
    assert step.host_reads == len(frames)
    assert len(step.graphs.graphs) >= 4 and step.graphs.replays > 0
    for k, (oe, oc) in enumerate(zip(outs["eager"], outs["compiled"])):
        for f in ("is_keyframe", "pnp_success", "ba_success", "n_tracked",
                  "n_landmarks", "n_alive", "n_ransac_inliers"):
            assert int(getattr(oe, f)) == int(getattr(oc, f)), (k, f)
        gap = float((oe.T_W_B - oc.T_W_B)[:3, 3].abs().max())
        assert gap <= 1e-5, (k, gap)
    assert any(bool(o.ba_success) for o in outs["compiled"])


@pytest.mark.gpu
def test_f64_config_frame_through_cuda_kernel(dev):
    """config/euroc_vo_dynamic.yaml with precision: f64 on the card: the
    kernel runs (float32 inside), the step stays float64, and the frames
    agree with the CPU's float64 run."""
    cfg = config_mod.load_config(os.path.join(CONFIG_DIR,
                                              "euroc_vo_dynamic.yaml"))
    cfg.precision = "f64"
    tex = bench_scene.make_texture(0)
    outs = {}
    for d in (torch.device("cpu"), dev):
        ecfg, rig = config_mod.make_estimator_config(cfg, kind="vo", device=d)
        step = est.make_estimator_step(ecfg)
        state = est.init_state(ecfg, dtype=torch.float64, device=d)
        rig32 = est.CameraRig(*(x.float() for x in rig))
        kk.klt_bidir.launches = 0
        outs[d.type] = []
        for k in range(2):
            a, b = bench_scene.render_rig(tex.to(d), rig32,
                                          (ecfg.cam_kind_l, ecfg.cam_kind_r),
                                          k, ecfg.image_shape)
            state, out = step(state, rig, a.double(), b.double())
            outs[d.type].append(out)
        launches = kk.klt_bidir.launches
        assert launches == (4 if d.type == "cuda" else 0)
    for oc, og in zip(outs["cpu"], outs["cuda"]):
        assert og.T_W_B.dtype == torch.float64
        assert int(oc.n_tracked) == int(og.n_tracked)
        assert float((oc.T_W_B - og.T_W_B.cpu()).abs().max()) <= 1e-3
    assert int(outs["cuda"][-1].n_alive) >= 100


# ---------------------------------------------------------------- the CLI

CLI_SHAPE = (96, 128)


def _cli_tree(root, n):
    """The small scene as a mini EuRoC tree (uint8 PNGs written by
    data.png) with a config of the same rig and frontend as _small_scene."""
    from rsvio_tpu_torch.data import writers

    _, frames, shape = _small_scene(n)
    h, w = shape
    u8 = [tuple(f.round().clamp(0, 255).to(torch.uint8).numpy()
                for f in pair) for pair in frames]
    stamps = [1_403_636_579_763_555_584 + 50_000_000 * k for k in range(n)]
    writers.write_euroc(str(root), u8, stamps)
    cfg = root / "config.yaml"
    cfg.write_text(f"""camera:
  image_width: {w}
  image_height: {h}
  left_intrinsics: [100.0, 100.0, {w / 2}, {h / 2}]
  left_distortion: [0.0, 0.0, 0.0, 0.0]
  right_intrinsics: [100.0, 100.0, {w / 2}, {h / 2}]
  right_distortion: [0.0, 0.0, 0.0, 0.0]
  T_B_Cl: [1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1]
  T_B_Cr: [1,0,0,0.11, 0,1,0,0, 0,0,1,0, 0,0,0,1]
keyframe_management:
  keyframe_window_size: 4
feature_detection:
  grid_size: 24
  optical_flow_max_iterations: 8
tracker:
  pyramid_levels: 3
  feature_capacity: 32
  detect_margin: 10
""")
    return str(root), str(cfg), u8


def _count_syncs(fn):
    """(result of fn(), the host syncs torch's sync debug mode reported
    while it ran, as file:line). Nests: an inner count takes its syncs out
    of the outer one."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, [f"{os.path.basename(w.filename)}:{w.lineno}"
                 for w in rec if "synchroniz" in str(w.message)]


@pytest.mark.gpu
def test_cli_on_cuda_matches_cpu(dev, tmp_path):
    """run_euroc on the card (kernel route) against --device cpu (plain
    versions): poses within the whole-step tolerance, 2 K1 launches a
    frame."""
    from rsvio_tpu_torch.cli import run_euroc
    from rsvio_tpu_torch.utils import trajectory

    root, cfg, _ = _cli_tree(tmp_path / "tree", 10)
    pos = {}
    for d in ("cpu", "cuda"):
        traj = str(tmp_path / f"{d}.txt")
        kk.klt_bidir.launches = 0
        assert run_euroc.main([cfg, root, "--device", d, "--quiet",
                               "--trajectory-out", traj]) == 0
        res = run_euroc.main.last_result
        assert res.n_failed == 0 and len(res.frame_processing_times_ms) == 10
        assert kk.klt_bidir.launches == (20 if d == "cuda" else 0)
        pos[d] = trajectory.load_tum(traj)[1]
    assert float(np.abs(pos["cuda"] - pos["cpu"]).max()) <= 1e-3
    assert float(pos["cuda"][-1, 0]) > 0.05


@pytest.mark.gpu
def test_cli_frame_adds_one_host_sync(dev, tmp_path, monkeypatch):
    """A CLI frame on the card makes exactly one host sync beyond the
    step's own: the batched read of the frame's outputs (cli/run.fetch).
    Frames arrive in pinned memory, so the upload adds none. The step (on
    the card the compiled step) is counted apart (a wrapper around each
    step call takes its syncs out): its only one the debug mode reports is
    the first call's read of the state's counts (its wait for is_kf each
    frame is an event's, which the mode does not report). The CLI's own
    syncs of runs of 5 and 3 frames differ by exactly two, both at the
    read (setup and teardown cancel out)."""
    from collections import Counter

    from rsvio_tpu_torch.cli import run_euroc

    root, cfg, _ = _cli_tree(tmp_path / "tree", 5)
    make_step = est.make_compiled_estimator_step
    step_syncs, steps = [], []

    def counted_step(ecfg, **kw):
        step = make_step(ecfg, **kw)
        steps.append(step)

        def f(*args):
            out, syncs = _count_syncs(lambda: step(*args))
            step_syncs.append(len(syncs))
            return out
        return f

    monkeypatch.setattr(est, "make_compiled_estimator_step", counted_step)

    def cli(n):
        return run_euroc.main([cfg, root, "--quiet", "--max-frames",
                               str(n)])

    assert cli(5) == 0           # warm-up: builds, first-use allocations
    own = {}
    for n in (3, 5):
        step_syncs.clear()
        rc, own[n] = _count_syncs(lambda: cli(n))
        assert rc == 0 and len(step_syncs) == n
        assert step_syncs == [1] + [0] * (n - 1) and \
            steps[-1].host_reads == n
    added = Counter(own[5])
    added.subtract(Counter(own[3]))
    added = {k: v for k, v in added.items() if v}
    assert list(added.values()) == [2] and \
        next(iter(added)).startswith("run.py:"), (added, own[3], own[5])


def test_png_round_trip_builds_the_unfilter(tmp_path):
    """write_png -> read_gray with every filter, 8 / 16 bits, gray and
    RGB: builds the C++ unfilter with the host compiler wherever this runs
    and holds it to the numpy version."""
    from rsvio_tpu_torch.data import png

    rng = np.random.default_rng(0)
    for shape, dtype in (((31, 45), np.uint8), ((31, 45), np.uint16),
                         ((31, 45, 3), np.uint8)):
        img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
        for filters in (0, 1, 2, 3, 4, png.cycle_filters(31)):
            path = str(tmp_path / "x.png")
            png.write_png(path, img, filters=filters)
            np.testing.assert_array_equal(png.read_png(path), img)
            np.testing.assert_array_equal(
                png.read_png(path, png.unfilter_numpy), img)
            gray = png.read_gray(path)
            assert gray.dtype == np.float32 and gray.shape == shape[:2]
            if dtype == np.uint16:
                np.testing.assert_array_equal(gray, (img >> 8).astype(
                    np.float32))
    assert png.load_library().path.endswith(".so")


@pytest.mark.gpu
def test_checkpoint_round_trip_on_cuda(dev, tmp_path):
    from rsvio_tpu_torch.utils import checkpoint

    cfg, frames, shape = _small_scene(4)
    rig = bench_scene.make_rig(dev, shape=shape, fx=100.0)
    step = est.make_estimator_step(cfg)
    state = est.init_state(cfg, device=dev)
    for a, b in frames:
        state, _ = step(state, rig, a.to(dev), b.to(dev))
    path = str(tmp_path / "s.ckpt")
    checkpoint.save_state(path, state)
    for d in (dev, torch.device("cpu")):
        back = checkpoint.load_state(path, est.init_state(cfg, device=d))
        for (n, x), (_, y) in zip(checkpoint.flatten(back),
                                  checkpoint.flatten(state)):
            assert x.device.type == d.type, n
            assert torch.equal(x.cpu(), y.cpu()), n


# ------------------------------------------------------------------ VIO

def _hover_imu(n=10, s=16):
    """Host IMU buffer of a body at constant velocity: accel (0, 0, +g),
    no rate; the first n of s samples valid (200 Hz)."""
    gyro = np.zeros((s, 3), np.float32)
    accel = np.zeros((s, 3), np.float32)
    accel[:, 2] = 9.81
    mask = np.zeros(s, bool)
    mask[:n] = True
    return gyro, accel, np.full(s, 0.005, np.float32), mask


def _vio_cfg(base, **base_kw):
    from rsvio_tpu_torch.models import estimator_vio as ev
    from rsvio_tpu_torch.models.vio_ba import VIOBAConfig
    return ev.VIOEstimatorConfig(base=base._replace(**base_kw), imu_buf=16,
                                 vio=VIOBAConfig(max_iterations=10))


@pytest.mark.gpu
@pytest.mark.parametrize("marg", [False, True], ids=["fifo", "marg"])
def test_vio_step_on_cuda_matches_cpu(dev, marg):
    """The VIO step on the small scene: CUDA (kernel) vs CPU (plain), flags
    and counts equal, poses within 3e-3 m (the float32 joint solve's
    noise, tests/test_torch_vio.py), velocity within 1e-2 m/s; 2 K1
    launches a frame."""
    from rsvio_tpu_torch.models import estimator_vio as ev

    base, frames, shape = _small_scene(10)
    cfg = _vio_cfg(base, use_marginalization=marg)
    step = ev.make_vio_estimator_step(cfg)
    outs, states = {}, {}
    for d in (torch.device("cpu"), dev):
        rig = bench_scene.make_rig(d, shape=shape, fx=100.0)
        state = ev.init_vio_state(cfg, device=d)
        kk.klt_bidir.launches = 0
        outs[d.type] = []
        for a, b in frames:
            state, out = step(state, rig, a.to(d), b.to(d), *_hover_imu())
            outs[d.type].append(out)
        states[d.type] = state
        assert kk.klt_bidir.launches == (20 if d.type == "cuda" else 0)
    for oc, og in zip(outs["cpu"], outs["cuda"]):
        for f in ("n_tracked", "is_keyframe", "ba_success", "n_landmarks"):
            assert int(getattr(oc, f)) == int(getattr(og, f)), f
        assert float((oc.T_W_B - og.T_W_B.cpu()).abs().max()) <= 3e-3
    assert float((states["cpu"].vel - states["cuda"].vel.cpu())
                 .abs().max()) <= 1e-2
    assert bool(states["cuda"].marg_prior.valid) == marg
    assert float(outs["cuda"][-1].T_W_B[0, 3]) > 0.05
    # The IMU buffer handed over as CUDA tensors (the whole buffer looped,
    # no host bound): the same poses, bit for bit.
    rig = bench_scene.make_rig(dev, shape=shape, fx=100.0)
    state = ev.init_vio_state(cfg, device=dev)
    imu_dev = [torch.from_numpy(x).to(dev) for x in _hover_imu()]
    for (a, b), og in zip(frames, outs["cuda"]):
        state, out = step(state, rig, a.to(dev), b.to(dev), *imu_dev)
        assert torch.equal(out.T_W_B, og.T_W_B)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_preintegrate_interval_buffer_on_cuda(dev, dtype):
    """preintegrate at interval_buf (512 samples, 300 of them live with
    holes) on CUDA against the CPU (float32 1e-5, float64 1e-10 of each
    field's largest entry), and its short loop bitwise the full loop."""
    from rsvio_tpu_torch.models import imu

    rng = np.random.default_rng(4)
    S, n = 512, 300
    gyro = rng.normal(0, 0.5, (S, 3))
    accel = rng.normal(0, 1.0, (S, 3)) + [0.0, 0.0, 9.81]
    dts = np.full(S, 0.005)
    mask = (np.arange(S) < n) & (rng.uniform(size=S) > 0.1)
    bg, ba = rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3)

    def run(d, n_steps=None):
        t = [torch.from_numpy(x).to(d, dtype) for x in (gyro, accel, dts)]
        return imu.preintegrate(*t, torch.from_numpy(mask).to(d),
                                torch.from_numpy(bg).to(d, dtype),
                                torch.from_numpy(ba).to(d, dtype),
                                n_steps=n_steps)

    cpu, full, short = run("cpu"), run(dev), run(dev, n_steps=n)
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    for f in imu.Preintegrated._fields:
        c, g = getattr(cpu, f), getattr(full, f)
        assert torch.equal(g, getattr(short, f)), f
        scale = max(float(c.abs().max()), 1e-30)
        assert float((g.cpu() - c).abs().max()) <= tol * scale, f


def _vio_window(dtype, W=5, L=30, seed=2):
    """A VIO window on the traj_6dof trajectory (numpy only): states
    perturbed, stereo observations, intervals preintegrated on the CPU."""
    from rsvio_tpu_torch.data import synthetic
    from rsvio_tpu_torch.models import imu, vio_ba

    rng = np.random.default_rng(seed)
    traj = synthetic.traj_6dof()
    kf_dt = 0.25
    T_gt = np.stack([traj.pose(kf_dt * i) for i in range(W)])
    vel = np.stack([(traj.pos_fn(kf_dt * i + 1e-5)
                     - traj.pos_fn(kf_dt * i - 1e-5)) / 2e-5
                    for i in range(W)])
    p_W = np.stack([rng.uniform(-3, 3, L), rng.uniform(4, 9, L),
                    rng.uniform(-2, 2, L)], axis=1)
    T_C_B = np.stack([np.eye(4)] * 2)
    T_C_B[1, 0, 3] = -0.11
    obs = np.zeros((W, 2, L, 2))
    mask = np.zeros((W, 2, L), bool)
    for i in range(W):
        Tbw = np.linalg.inv(T_gt[i])
        for c in range(2):
            pC = (T_C_B[c][:3, :3] @ (Tbw[:3, :3] @ p_W.T + Tbw[:3, 3:4])
                  + T_C_B[c][:3, 3:4]).T
            ok = pC[:, 2] > 0.5
            obs[i, c, ok] = pC[ok, :2] / pC[ok, 2:3]
            mask[i, c] = ok
    pres = []
    for i in range(W - 1):
        _, g, a, d = traj.sample_imu(kf_dt * i, kf_dt * (i + 1))
        t = [torch.from_numpy(x).double() for x in (g, a, d)]
        pres.append(imu.preintegrate(*t, torch.ones(len(d), dtype=torch.bool),
                                     torch.zeros(3, dtype=torch.float64),
                                     torch.zeros(3, dtype=torch.float64)))
    pre = imu.Preintegrated(*(torch.stack(x).to(dtype) for x in zip(*pres)))
    T0 = T_gt.copy()
    for i in range(1, W):
        T0[i, :3, 3] += rng.normal(size=3) * 0.02
    st = vio_ba.VIOState(
        T_W_B=torch.from_numpy(T0).to(dtype),
        vel=torch.from_numpy(vel + rng.normal(size=vel.shape) * 0.05)
        .to(dtype),
        bg=torch.zeros((W, 3), dtype=dtype), ba=torch.zeros((W, 3),
                                                            dtype=dtype))
    lms = torch.from_numpy(p_W + rng.normal(size=p_W.shape) * 0.05).to(dtype)
    return (st, torch.from_numpy(T_C_B).to(dtype), lms,
            torch.from_numpy(obs).to(dtype), torch.from_numpy(mask),
            torch.ones(L, dtype=torch.bool), pre,
            torch.ones(W - 1, dtype=torch.bool))


def _to(x, d):
    if hasattr(x, "_fields"):
        return type(x)(*(_to(v, d) for v in x))
    if isinstance(x, tuple):
        return tuple(_to(v, d) for v in x)
    return x.to(d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fn", ["solve_vio_ba", "solve_vio_ba_marginalized"])
def test_vio_solvers_on_cuda_match_cpu(dev, fn, dtype):
    """The joint window solves on CUDA against the CPU, with the chi^2
    gate: float64 the same iterations and status, states within 1e-8 and
    the next prior within 1e-8 of max|H|; float32 (which stops on the
    iteration cap at its resolution) states within 1e-2."""
    from rsvio_tpu_torch.models import marginalization as mg
    from rsvio_tpu_torch.models import vio_ba

    args = _vio_window(dtype)
    cfg = vio_ba.VIOBAConfig(chi2_gate=0.01)
    res = {}
    for d in (torch.device("cpu"), dev):
        a = _to(args, d)
        if fn == "solve_vio_ba":
            res[d.type] = (vio_ba.solve_vio_ba(*a, cfg=cfg), None)
        else:
            p0 = mg.empty_prior(5, 15, dtype, d)
            r1, p1 = vio_ba.solve_vio_ba_marginalized(
                *a, p0, torch.ones((), dtype=torch.bool, device=d), cfg)
            res[d.type] = vio_ba.solve_vio_ba_marginalized(
                *a, p1, torch.ones((), dtype=torch.bool, device=d), cfg)
    (rc, pc), (rg, pg) = res["cpu"], res["cuda"]
    assert bool(rc.success) and bool(rg.success)
    f64 = dtype == torch.float64
    if f64:
        assert int(rc.iterations) == int(rg.iterations)
        assert int(rc.status) == int(rg.status)
    for f in vio_ba.VIOState._fields:
        err = float((getattr(rg.state, f).cpu() - getattr(rc.state, f))
                    .abs().max())
        assert err <= (1e-8 if f64 else 1e-2), (f, err)
    if pc is not None and f64:
        scale = max(1.0, float(pc.H.abs().max()))
        for f in ("H", "g"):
            assert float((getattr(pg, f).cpu() - getattr(pc, f)).abs()
                         .max()) <= 1e-8 * scale, f


@pytest.mark.gpu
def test_vio_frame_syncs_equal_vo_step(dev):
    """Host syncs per frame (torch's sync debug mode): the VIO step, with
    its IMU buffer handed over as host arrays (one pinned upload), makes
    exactly as many as the VO step on the same frames, frame kind by frame
    kind (keyframe with BA, without a keyframe). Each sequence runs twice
    and the second pass is counted."""
    from rsvio_tpu_torch.models import estimator_vio as ev

    base, frames, shape = _small_scene(10)
    rig = bench_scene.make_rig(dev, shape=shape, fx=100.0)
    frames_d = [(a.to(dev), b.to(dev)) for a, b in frames]
    vcfg = _vio_cfg(base)
    runs = {"vo": (est.make_estimator_step(base),
                   lambda: est.init_state(base, device=dev), ()),
            "vio": (ev.make_vio_estimator_step(vcfg),
                    lambda: ev.init_vio_state(vcfg, device=dev),
                    _hover_imu())}
    per_kind, where = {}, {}
    for name, (step, init, imu_args) in runs.items():
        for counted in (False, True):
            state = init()
            torch.cuda.synchronize()
            for a, b in frames_d:
                (state, out), syncs = _count_syncs(
                    lambda: step(state, rig, a, b, *imu_args))
                if counted:
                    key = (bool(out.is_keyframe), bool(out.ba_success))
                    per_kind.setdefault(name, {}).setdefault(
                        key, set()).add(len(syncs))
                    where.setdefault((name, key), syncs)
    assert per_kind["vio"].get((True, True)) and \
        per_kind["vio"].get((False, False))
    for key, counts in per_kind["vio"].items():
        assert key in per_kind["vo"], (key, per_kind)
        assert counts == per_kind["vo"][key], (
            key, per_kind, where[("vo", key)], where[("vio", key)])


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [
    dict(), dict(use_marginalization=True),
    dict(use_obs_weights=True, pnp_prior_adaptive=True,
         vision_weight_adaptive=True)],
    ids=["fifo", "marg", "gate"])
def test_compiled_vio_step_on_cuda_matches_eager(dev, opts):
    """make_compiled_vio_estimator_step on the card (CUDA graphs) against
    the eager VIO step over 30 frames of the small scene with the hover IMU
    buffer (host arrays): flags and counts equal, poses within 1e-5 m,
    exactly 2 K1 launches a frame and one blocking read a frame (every
    call after the first under torch.cuda.set_sync_debug_mode("error")).
    The same frames with the IMU buffer as CUDA tensors: the same poses,
    bit for bit, and one more blocking read a frame (its valid count)."""
    from rsvio_tpu_torch.models import estimator_vio as ev

    base, frames, shape = _small_scene(30)
    pnp = base.pnp
    if opts.get("pnp_prior_adaptive"):
        pnp = pnp._replace(ransac_hypotheses=16, motion_prior_weight=20.0)
    cfg = _vio_cfg(base, pnp=pnp, **opts)
    rig = bench_scene.make_rig(dev, shape=shape, fx=100.0)
    frames_d = [(a.to(dev), b.to(dev)) for a, b in frames]
    imu_dev = [torch.from_numpy(x).to(dev) for x in _hover_imu()]
    outs, steps = {}, {}
    for name in ("eager", "compiled", "compiled_dev"):
        step = (ev.make_vio_estimator_step(cfg) if name == "eager"
                else ev.make_compiled_vio_estimator_step(cfg, device=dev))
        state = ev.init_vio_state(cfg, device=dev)
        torch.cuda.synchronize()
        kk.klt_bidir.launches = 0
        outs[name] = []
        for k, (a, b) in enumerate(frames_d):
            imu_args = imu_dev if name == "compiled_dev" else _hover_imu()
            if name == "compiled" and k > 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, out = step(state, rig, a, b, *imu_args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            outs[name].append(est.FrameOutput(*(t.clone() for t in out)))
        assert kk.klt_bidir.launches == 2 * len(frames), name
        steps[name] = step
    assert steps["compiled"].host_reads == len(frames)
    assert steps["compiled_dev"].host_reads == 2 * len(frames)
    graphs = steps["compiled"].graphs
    assert len(graphs.graphs) >= 4 and graphs.replays > 0
    for k, (oe, oc, od) in enumerate(zip(outs["eager"], outs["compiled"],
                                         outs["compiled_dev"])):
        for f in ("is_keyframe", "pnp_success", "ba_success", "n_tracked",
                  "n_landmarks", "n_alive", "n_ransac_inliers"):
            assert int(getattr(oe, f)) == int(getattr(oc, f)), (k, f)
        gap = float((oe.T_W_B - oc.T_W_B)[:3, 3].abs().max())
        assert gap <= 1e-5, (k, gap)
        assert torch.equal(oc.T_W_B, od.T_W_B), k
    assert any(bool(o.ba_success) for o in outs["compiled"])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["vo", "vio"])
def test_compiled_step_traced_on_cuda(dev, kind):
    """The compiled VO and VIO steps over 20 frames of the small scene with
    the tracer off and on (profiling.recording()), after a pass that
    captures every variant: the poses bit for bit equal, one blocking read
    a frame either way (every call after the first under
    torch.cuda.set_sync_debug_mode("error"), so the spans and the device
    events add no host sync), and with the tracer on one ``graph.device``
    record with a positive time for each ``graph.replay`` (but the last
    frame's, read at a next call, which does not come) and a ``stream.gap``
    before every one but the pass's first. The pose is read after every
    frame, as a user reads it."""
    from rsvio_tpu_torch import profiling
    from rsvio_tpu_torch.models import estimator_vio as ev

    base, frames, shape = _small_scene(20)
    rig = bench_scene.make_rig(dev, shape=shape, fx=100.0)
    frames_d = [(a.to(dev), b.to(dev)) for a, b in frames]
    if kind == "vio":
        cfg = _vio_cfg(base)
        step = ev.make_compiled_vio_estimator_step(cfg, device=dev)
        init, imu = (lambda: ev.init_vio_state(cfg, device=dev)), \
            _hover_imu()
    else:
        step = est.make_compiled_estimator_step(base, device=dev)
        init, imu = (lambda: est.init_state(base, device=dev)), ()
    host = torch.zeros(4, 4, pin_memory=True)
    done = torch.cuda.Event()
    poses, reads = {}, {}
    for name in ("capture", "off", "on"):
        state = init()
        torch.cuda.synchronize()
        profiling.clear()
        before = step.host_reads
        poses[name] = []
        with profiling.recording() if name == "on" else \
                contextlib.nullcontext():
            for k, (a, b) in enumerate(frames_d):
                if k > 0:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    state, out = step(state, rig, a, b, *imu)
                    host.copy_(out.T_W_B, non_blocking=True)
                    done.record()
                    done.synchronize()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                poses[name].append(host.clone())
        reads[name] = step.host_reads - before
        rec = profiling.records()
        if name == "off":
            assert not rec.spans and not rec.device
    for k, (p_off, p_on) in enumerate(zip(poses["off"], poses["on"])):
        assert torch.equal(p_off, p_on), k
    assert reads["off"] == reads["on"] == len(frames)
    names = [s.name for s in rec.spans]
    assert names.count("step") == len(frames)
    assert "graph.capture" not in names
    last = len(frames) - 1
    for k in range(len(frames)):
        replays = [s.attrs["key"] for s in rec.spans
                   if s.name == "graph.replay" and s.attrs["frame"] == k]
        device = [d for d in rec.device
                  if d.name == "graph.device" and d.attrs["frame"] == k]
        assert len(replays) >= 2
        assert [d.attrs["key"] for d in device] == \
            ([] if k == last else replays), k
        assert [d.attrs["layer"] for d in device] == \
            ([] if k == last else
             ["motion"] + ["keyframe"] * (len(replays) - 1)), k
        assert all(d.ns > 0 for d in device)
    n_device = sum(d.name == "graph.device" for d in rec.device)
    n_gap = sum(d.name == "stream.gap" for d in rec.device)
    assert n_gap == n_device - 1


@pytest.mark.gpu
def test_compiled_mono_step_on_cuda_matches_eager(dev):
    """make_compiled_mono_step on the card against the eager pyramid build
    and mono_tracker_step over 20 frames (config/tartanair.yaml's tracker
    at 96x128): the counts and the table's alive / id fields equal,
    positions within 1e-4 px, K1 launched once a frame after the first, and
    no blocking read (every call under set_sync_debug_mode("error"))."""
    from rsvio_tpu_torch.models import mono_tracker as mt

    shape = (96, 128)
    tex = bench_scene.make_texture(1, size=768,
                                   octaves=((90.0, 24), (60.0, 96)))
    imgs = [bench_scene.render(tex, 0.02 * k, shape=shape, fx=100.0,
                               plane_z=4.0, scale=60.0,
                               offset=200.0).to(dev) for k in range(20)]
    cfg = mt.MonoTrackerConfig(
        capacity=48, cell_size=12, detect_margin=8, min_score=2.5 / 4000.0,
        detect_mode="nms", nms_radius=8, nms_max_new=32,
        klt=KLTConfig(levels=3, max_iterations=30,
                      convergence_threshold=0.005, lm_lambda=0.1,
                      pyramid_ratio=0.5))

    def make_pyramid(img):
        return pyramid.build_pyramid_ratio(img, 3, 0.5, blur=True,
                                           blur_sigma=2.0)

    runs = {}
    for name in ("eager", "compiled"):
        table = mt.init_mono_table(cfg.capacity, device=dev)
        step = mt.make_compiled_mono_step(cfg, make_pyramid, device=dev)
        torch.cuda.synchronize()
        kk.klt_bidir.launches = 0
        runs[name], prev = [], None
        for k, img in enumerate(imgs):
            if name == "eager":
                pyr = make_pyramid(img)
                table, stats = mt.mono_tracker_step(
                    table, pyr if k == 0 else prev, pyr, cfg,
                    first_frame=k == 0)
                prev = pyr
            else:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    table, stats = step(table, img, first_frame=k == 0)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            runs[name].append([t.clone() for t in (
                table.pos, table.alive, table.fid, stats["tracked"],
                stats["alive"])])
        assert kk.klt_bidir.launches == len(imgs) - 1, name
    assert step.host_reads == 0 and step.graphs.replays == len(imgs) - 2
    for k, (e, c) in enumerate(zip(runs["eager"], runs["compiled"])):
        for x, y in zip(e[1:], c[1:]):
            assert torch.equal(x, y), k
        alive = e[1]
        assert float((e[0] - c[0])[alive].abs().max()) <= 1e-4, k
    assert min(int(e[3]) for e in runs["eager"][1:]) >= 8


# ------------------------------------------------------------ distributed

@pytest.mark.gpu
def test_sharded_solvers_gloo_two_ranks_on_cuda(dev, tmp_path):
    from rsvio_tpu_torch.parallel import dryrun
    res = dryrun.run_ranks(torch_dist_ranks.cuda_solver_parity, 2,
                           backend="gloo", devices="cuda", timeout=300.0,
                           workdir=str(tmp_path))
    for name in ("ba", "ba_marg", "vio", "vio_marg"):
        assert res[0][f"{name}.success"].all(), name
        assert float(res[0][f"{name}.excess"]) <= 0.0, name
        if f"{name}.dH" in res[0]:
            assert float(res[0][f"{name}.dH"]) <= 5e-3, name
        np.testing.assert_array_equal(res[0][f"{name}.T_W_B"],
                                      res[1][f"{name}.T_W_B"])


@pytest.fixture(scope="module")
def nccl_mesh():
    """A world-size-1 NCCL group in this process, destroyed after the
    module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from rsvio_tpu_torch.parallel import mesh as mesh_mod
    m = mesh_mod.make_mesh(backend="nccl")
    yield m
    dist.destroy_process_group()


@pytest.mark.gpu
def test_nccl_world_size_one_solve(nccl_mesh):
    from rsvio_tpu_torch.parallel import dist_ba, dryrun
    assert (nccl_mesh.size, nccl_mesh.backend) == (1, "nccl")
    prob = dryrun.window_problem(10, 64, device=nccl_mesh.device)
    c0 = dict(nccl_mesh.counts)
    rd = dist_ba.solve_ba_distributed(nccl_mesh, *prob)
    rs = ba_mod.solve_ba(*prob)
    assert nccl_mesh.counts["all_reduce_calls"] > c0["all_reduce_calls"]
    assert bool(rd.success)
    for f in ("T_W_B", "landmarks", "final_cost", "iterations", "metrics"):
        assert torch.equal(getattr(rd, f), getattr(rs, f)), f


@pytest.mark.gpu
def test_distributed_step_syncs_equal_single_step(nccl_mesh):
    """Host syncs per frame (torch's sync debug mode), frame kind by frame
    kind: the distributed VO step over NCCL at world size 1 makes exactly
    as many as the single-device step (NCCL's collectives add none; over
    gloo each collective stages through the host). Each sequence runs
    twice and the second pass is counted."""
    from rsvio_tpu_torch.parallel.dist_estimator import (
        make_distributed_estimator_step)
    dev = nccl_mesh.device
    base, frames, shape = _small_scene(10)
    rig = bench_scene.make_rig(dev, shape=shape, fx=100.0)
    frames_d = [(a.to(dev), b.to(dev)) for a, b in frames]
    runs = {"single": est.make_estimator_step(base),
            "dist": make_distributed_estimator_step(base, nccl_mesh)}
    per_kind, where = {}, {}
    for name, step in runs.items():
        for counted in (False, True):
            state = est.init_state(base, device=dev)
            torch.cuda.synchronize()
            for a, b in frames_d:
                (state, out), syncs = _count_syncs(
                    lambda: step(state, rig, a, b))
                if counted:
                    key = (bool(out.is_keyframe), bool(out.ba_success))
                    per_kind.setdefault(name, {}).setdefault(
                        key, set()).add(len(syncs))
                    where.setdefault((name, key), syncs)
    assert per_kind["dist"].get((True, True))
    assert per_kind["dist"] == per_kind["single"], (
        per_kind, {k: v for k, v in where.items() if k[1] == (True, True)})


def _eval_sequence(n, vio=False):
    """tests/test_torch_evaluation.py's small runs: depth_6dof (VO) or
    tests/test_vio_init.py's plane at 2.5 m on a gentler 6-DoF trajectory
    (VIO), rendered on the CPU (the same frames for both devices), n frames
    at 10 Hz with the accuracy matrix's IMU biases and noise."""
    import dataclasses

    from rsvio_tpu_torch.data import synthetic as syn
    if vio:
        scene = dataclasses.replace(
            syn.scene_easy_plane(H=120, W=188, device="cpu"),
            planes=[syn._frontal_plane(2.5, 7.0, 5.0, 0, device="cpu")])
        traj = syn.traj_6dof(lin_amp=(0.5, 0.2, 0.15),
                             ang_amp_deg=(4.0, 3.0, 2.0))
    else:
        scene = syn.scene_depth_structured(H=120, W=188, device="cpu")
        traj = syn.traj_6dof()
    rng = np.random.default_rng(11)
    seq = syn.generate_sequence(
        scene, traj, n, fps=10.0, imu_rate=200.0,
        imu_kwargs=dict(noise_rng=rng, gyro_bias=[0.003, -0.002, 0.004],
                        accel_bias=[0.02, -0.015, 0.01], gyro_noise=1.7e-4,
                        accel_noise=2.0e-3))
    return scene, traj, seq


EVAL_SMALL = dict(capacity=96, window=5, levels=3, cell_size=24,
                  detect_margin=10, translation_threshold=0.03,
                  rotation_threshold=0.03)


@pytest.mark.gpu
@pytest.mark.parametrize("profile", ["vo_fifo", "vo_adapt", "vio_fifo"])
def test_run_synthetic_sequence_cuda_matches_cpu(dev, profile):
    """utils.evaluation.run_synthetic_sequence on the card (kernel route)
    against the CPU (plain versions) on the same frames: positions within
    the whole-step tolerance (1e-3 m; VIO 3e-3 m, the float32 joint solve's,
    as test_vio_step_on_cuda_matches_cpu), keyframes and BA outcomes equal,
    and exactly 2 K1 launches a frame on the card. The VIO run is on the
    plane scene: on depth_6dof at this width its float32 trajectory moves
    by centimetres with the order of a sum (tests/test_torch_evaluation.py).
    """
    from rsvio_tpu_torch.utils import evaluation
    vio = profile == "vio_fifo"
    scene, traj, seq = _eval_sequence(14, vio)
    kw = dict(EVAL_SMALL, **{
        "vo_fifo": dict(), "vo_adapt": dict(motion_prior=20.0, ransac=16,
                                            adaptive=True),
        "vio_fifo": dict(use_vio=True)}[profile])
    if kw.get("use_vio"):
        kw["init_gyro"], kw["init_accel"] = evaluation.static_init_imu(traj)
    res = {}
    for d in ("cpu", "cuda"):
        kk.klt_bidir.launches = 0
        res[d] = evaluation.run_synthetic_sequence(seq, scene, device=d,
                                                   **kw)
        assert kk.klt_bidir.launches == (2 * 14 if d == "cuda" else 0)
    assert float(np.abs(res["cuda"].positions
                        - res["cpu"].positions).max()) <= (3e-3 if vio
                                                            else 1e-3)
    for f in ("is_keyframe", "ba_success"):
        np.testing.assert_array_equal(res["cuda"].stats[f],
                                      res["cpu"].stats[f])
    assert np.isfinite(res["cuda"].positions).all()
    assert res["cuda"].fps > 0


@pytest.mark.gpu
def test_run_synthetic_sequence_reads_once_a_frame(dev, monkeypatch):
    """The harness's loop makes exactly one host sync a frame beyond the
    step's own: its batched read of the frame's outputs. The step's syncs
    are taken out by a wrapper around each step call; frames are on the
    card already, and the harness's own syncs of runs of 7 and 5 frames
    differ by exactly two, both at the read."""
    from collections import Counter

    from rsvio_tpu_torch.data import synthetic as syn
    from rsvio_tpu_torch.utils import evaluation

    scene = syn.scene_depth_structured(H=120, W=188, device=dev)
    seq = syn.generate_sequence(scene, syn.traj_6dof(), 7, fps=10.0)
    # Without a probe the harness drives the compiled step.
    make_step = est.make_compiled_estimator_step
    step_syncs = []

    def counted_step(ecfg, **kw):
        step = make_step(ecfg, **kw)

        def f(*args):
            out, syncs = _count_syncs(lambda: step(*args))
            step_syncs.append(len(syncs))
            return out
        return f

    monkeypatch.setattr(est, "make_compiled_estimator_step", counted_step)

    def run(n):
        part = dict(seq, frames=seq["frames"][:n], ts=seq["ts"][:n],
                    gt_T_W_B=seq["gt_T_W_B"][:n])
        return evaluation.run_synthetic_sequence(part, scene, device=dev,
                                                 **EVAL_SMALL)

    run(7)                       # warm-up: kernel build, allocations
    own = {}
    for n in (5, 7):
        step_syncs.clear()
        _, own[n] = _count_syncs(lambda: run(n))
        assert len(step_syncs) == n and min(step_syncs) > 0
    added = Counter(own[7])
    added.subtract(Counter(own[5]))
    added = {k: v for k, v in added.items() if v}
    assert list(added.values()) == [2] and \
        next(iter(added)).startswith("evaluation.py:"), (added, own[5])


@pytest.mark.gpu
@pytest.mark.parametrize("run", ["vo", "vo_marg", "vio"])
def test_compiled_dist_step_on_cuda_matches_eager(nccl_mesh, run):
    """The compiled distributed steps (CUDA graphs, the sharded solve's NCCL
    collectives captured) at world size 1 in this process against the
    eager distributed steps over 30 frames of the small scene (VIO: the
    hover IMU buffer): flags equal, poses within 1e-5 m, the mesh's
    collective counts of the run equal, exactly 2 K1 launches and one
    blocking read a frame (every call after the first under
    torch.cuda.set_sync_debug_mode("error"))."""
    from rsvio_tpu_torch.models import estimator_vio as ev
    from rsvio_tpu_torch.parallel import dist_estimator as de

    dev = nccl_mesh.device
    base, frames, shape = _small_scene(30)
    vio = run == "vio"
    cfg = base._replace(use_marginalization=run == "vo_marg")
    if vio:
        cfg = _vio_cfg(cfg)
        makers = (de.make_distributed_vio_estimator_step,
                  de.make_compiled_distributed_vio_estimator_step)
    else:
        makers = (de.make_distributed_estimator_step,
                  de.make_compiled_distributed_estimator_step)
    rig = bench_scene.make_rig(dev, shape=shape, fx=100.0)
    frames_d = [(a.to(dev), b.to(dev)) for a, b in frames]
    imu = _hover_imu() if vio else ()
    outs, counts = {}, {}
    for name, make in zip(("eager", "compiled"), makers):
        step = make(cfg, nccl_mesh)
        state = (ev.init_vio_state(cfg, device=dev) if vio
                 else est.init_state(cfg, device=dev))
        torch.cuda.synchronize()
        kk.klt_bidir.launches = 0
        c0 = dict(nccl_mesh.counts)
        outs[name] = []
        for k, (a, b) in enumerate(frames_d):
            if name == "compiled" and k > 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, out = step(state, rig, a, b, *imu)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            outs[name].append(est.FrameOutput(*(t.clone() for t in out)))
        assert kk.klt_bidir.launches == 2 * len(frames), name
        counts[name] = {k: nccl_mesh.counts[k] - c0[k] for k in c0}
    assert step.host_reads == len(frames)
    assert counts["compiled"] == counts["eager"]
    assert counts["compiled"]["all_reduce_calls"] > 0
    for k, (oe, oc) in enumerate(zip(outs["eager"], outs["compiled"])):
        for f in ("is_keyframe", "pnp_success", "ba_success", "n_tracked",
                  "n_landmarks", "n_alive"):
            assert int(getattr(oe, f)) == int(getattr(oc, f)), (k, f)
        gap = float((oe.T_W_B - oc.T_W_B)[:3, 3].abs().max())
        assert gap <= 1e-5, (k, gap)
    assert any(bool(o.ba_success) for o in outs["compiled"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["solve_ba", "solve_vio_ba"])
def test_compiled_function_on_cuda_matches_eager(dev, name):
    """utils.graphs.compile_function on the card: solve_ba and solve_vio_ba
    (W=10, L=256, dryrun's windows) as CUDA graphs against the eager calls,
    poses and landmarks within 1e-5 (the same kernels in the same order),
    every replay under torch.cuda.set_sync_debug_mode("error"), one graph
    for two calls of one layout."""
    from rsvio_tpu_torch.models import vio_ba
    from rsvio_tpu_torch.parallel import dryrun
    from rsvio_tpu_torch.utils.graphs import compile_function

    if name == "solve_ba":
        fn, args = ba_mod.solve_ba, dryrun.window_problem(10, 256, seed=1,
                                                          device=dev)
    else:
        fn, args = vio_ba.solve_vio_ba, dryrun.vio_window_problem(
            10, 256, seed=1, device=dev)
    want = fn(*args)
    cf = compile_function(fn, dev)
    for k in range(3):
        if k > 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = cf(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        pose = (lambda r: r.state.T_W_B) if name == "solve_vio_ba" \
            else (lambda r: r.T_W_B)
        assert float((pose(got) - pose(want)).abs().max()) <= 1e-5, k
        assert float((got.landmarks - want.landmarks).abs().max()) <= 1e-5
        assert bool(got.success) == bool(want.success)
    assert len(cf.graphs.graphs) == 1 and cf.graphs.replays == 2


@pytest.mark.gpu
@pytest.mark.parametrize("profile", ["vo_fifo", "vio_fifo"])
def test_eval_harness_compiled_on_cuda_matches_eager(dev, profile):
    """utils.evaluation.run_synthetic_sequence on the card without a probe
    (the compiled step) against the same call with a probe (the eager step)
    on the same 14 frames: positions within 1e-5 m, the per-frame
    statistics equal, exactly 2 K1 launches a frame each."""
    from rsvio_tpu_torch.utils import evaluation
    vio = profile == "vio_fifo"
    scene, traj, seq = _eval_sequence(14, vio)
    kw = dict(EVAL_SMALL, use_vio=vio)
    if vio:
        kw["init_gyro"], kw["init_accel"] = evaluation.static_init_imu(traj)
    res = {}
    for name, probe in (("compiled", None), ("eager", {})):
        kk.klt_bidir.launches = 0
        res[name] = evaluation.run_synthetic_sequence(
            seq, scene, device=dev, probe=probe, **kw)
        assert kk.klt_bidir.launches == 2 * 14, name
    assert float(np.abs(res["compiled"].positions
                        - res["eager"].positions).max()) <= 1e-5
    for f in ("n_tracked", "is_keyframe", "ba_success", "pnp_success"):
        np.testing.assert_array_equal(res["compiled"].stats[f],
                                      res["eager"].stats[f])
    assert res["compiled"].ba_success_rate > 0


# --------------------------------------------------------------------------
# The window solve's visual assembly (K3, ops.cuda.ba_kernel)
# --------------------------------------------------------------------------

# Kernel vs plain version, relative to each output's largest magnitude: the
# two take their sums (the matrix-vector products of a point's transform,
# the block sums over observations, landmarks and blocks) in another order,
# and the residual's cancellation (proj - obs) carries a few roundings of
# the projection into it: float32 ~1e-6 of the scale, float64 ~1e-15.
BA_REL = {torch.float32: 2e-5, torch.float64: 1e-12}


def _ba_window(dtype, dev, W=10, L=253, seed=1):
    """tests/test_torch_ba_assemble's window (points behind the camera,
    masked slots, an invalid slot, gated outliers, a landmark the gate
    strips of one camera) at the solves' W and a ragged L, ~0.5 px of
    noise, on `dev`."""
    from test_torch_ba_assemble import _window
    T_B_W, T_C_B, lms, obs, mask, valid, w = _window(dtype, W, L, seed)
    gen = torch.Generator().manual_seed(seed)
    obs = obs + (torch.randn(obs.shape, generator=gen, dtype=torch.float64)
                 * 1e-3).to(dtype)
    return [t.to(dev) for t in (T_B_W, T_C_B, lms, obs, mask, valid, w)]


def _ba_close(a, b, rel):
    if a is None:
        assert b is None
        return
    if a.dtype in (torch.bool, torch.int64):
        assert torch.equal(a, b)
        return
    scale = max(float(b.abs().max()), 1e-30) if b.numel() else 1.0
    err = float((a - b).abs().max()) if b.numel() else 0.0
    assert err <= rel * scale, (err, scale)


def _ba_compare(got, want, rel):
    for a, b in zip(got.blocks, want.blocks):
        _ba_close(a, b, rel)
    _ba_close(got.r_sq, want.r_sq, rel)
    assert (got.gated is None) == (want.gated is None)
    if got.gated is not None:
        for a, b in zip(got.gated, want.gated):
            _ba_close(a, b, rel)
        for f in ("gate_mask", "gate_active", "n_obs", "n_active"):
            _ba_close(getattr(got, f), getattr(want, f), rel)


@pytest.mark.gpu
@pytest.mark.parametrize("gate", [0.0, 0.02], ids=["nogate", "gate"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_ba_assemble_kernel_matches_plain_version(dev, dtype, weighted, gate):
    """K3 against ba_assemble_reference on the same CUDA tensors (BA_REL;
    masks, counts equal), one call a launch; a second launch gives the
    same bits (fixed-order sums, no atomics)."""
    from rsvio_tpu_torch.ops.cuda import ba_kernel
    T_B_W, T_C_B, lms, obs, mask, valid, w = _ba_window(dtype, dev)
    args = (T_B_W, T_C_B, lms, obs, mask, w if weighted else None, valid,
            0.05, gate)
    before = ba_kernel.ba_assemble.launches
    got = ba_kernel.ba_assemble(*args)
    again = ba_kernel.ba_assemble(*args)
    torch.cuda.synchronize()
    assert ba_kernel.ba_assemble.launches == before + 2
    want = ba_kernel.ba_assemble_reference(*args)
    _ba_compare(got, want, BA_REL[dtype])
    for a, b in zip(got, again):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        elif a is not None:
            assert torch.equal(a, b)
    if gate > 0:
        assert not bool(got.gate_active[2]) and int(got.n_active) > 100


@pytest.mark.gpu
@pytest.mark.parametrize("W,L", [(16, 1), (16, 40), (2, 9)])
def test_ba_assemble_kernel_window_limits(dev, W, L):
    """The kernel's largest window (a warp's 32 lanes), a single landmark
    (one block, seven idle warps) and a small window against the plain
    version; one keyframe more than the kernel takes raises."""
    from rsvio_tpu_torch.ops.cuda import ba_kernel
    from rsvio_tpu_torch.parallel import dryrun
    T_W_B, T_C_B, lms, obs, mask, valid = dryrun.window_problem(
        W, L, seed=2, device=dev, dtype=torch.float32)
    T_B_W = lie.se3_inverse(T_W_B)
    got = ba_kernel.ba_assemble(T_B_W, T_C_B, lms, obs, mask, None, valid,
                                2.0, 0.01)
    want = ba_kernel.ba_assemble_reference(T_B_W, T_C_B, lms, obs, mask,
                                           None, valid, 2.0, 0.01)
    _ba_compare(got, want, BA_REL[torch.float32])
    T_W_B, T_C_B, lms, obs, mask, valid = dryrun.window_problem(
        17, 8, seed=2, device=dev, dtype=torch.float32)
    with pytest.raises(ValueError):
        ba_kernel.ba_assemble(lie.se3_inverse(T_W_B), T_C_B, lms, obs, mask,
                              None, valid, 2.0, 0.01)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("fn", ["solve_ba", "solve_ba_marginalized",
                                "solve_vio_ba"])
def test_window_solves_through_ba_assemble_match_cpu(dev, fn, dtype):
    """The solves at the cells' shapes (W=10, L=256, gate 0.01308, weights)
    through K3 on the card against the plain version on the CPU, at
    tests/test_torch_solvers.py's tolerances: float32 poses within 1e-4,
    landmarks 1e-3 relative; float64 the same iterations and status, poses
    within 1e-9, metrics within 1e-6 relative (the gain ratio 1e-4). K3
    runs once for the first system and once an LM iteration (fixed trip):
    21 launches a solve_ba and a VIO solve, 22 a marginalized solve (the
    next prior's system)."""
    from rsvio_tpu_torch.models import marginalization as mg
    from rsvio_tpu_torch.models import vio_ba
    from rsvio_tpu_torch.ops.cuda import ba_kernel
    from rsvio_tpu_torch.parallel import dryrun

    gen = torch.Generator().manual_seed(3)
    problem = (dryrun.vio_window_problem if fn == "solve_vio_ba"
               else dryrun.window_problem)
    args = list(problem(10, 256, seed=1, device="cpu", dtype=dtype))
    obs = args[3] + (torch.randn(args[3].shape, generator=gen,
                                 dtype=torch.float64) * 1e-3).to(dtype)
    obs[4, 1, :6] += 0.05
    args[3] = obs
    w = (0.5 + torch.rand((10, 256), generator=gen,
                          dtype=torch.float64)).to(dtype)
    res, launches = {}, {}
    for d in (torch.device("cpu"), dev):
        a = [_to(x, d) for x in args]
        before = ba_kernel.ba_assemble.launches
        if fn == "solve_ba":
            r = ba_mod.solve_ba(*a, ba_mod.BAConfig(chi2_gate=0.01308),
                                obs_weight=w.to(d))
            pose = r.T_W_B
        elif fn == "solve_ba_marginalized":
            r, _ = ba_mod.solve_ba_marginalized(
                *a, mg.empty_prior(10, 6, dtype, d),
                torch.ones((), dtype=torch.bool, device=d),
                ba_mod.BAConfig(chi2_gate=0.01308), obs_weight=w.to(d))
            pose = r.T_W_B
        else:
            r = vio_ba.solve_vio_ba(*a, cfg=vio_ba.VIOBAConfig(
                chi2_gate=0.01308), obs_weight=w.to(d))
            pose = r.state.T_W_B
        if d.type == "cuda":
            torch.cuda.synchronize()
        launches[d.type] = ba_kernel.ba_assemble.launches - before
        res[d.type] = (r, pose.cpu(), r.landmarks.cpu(), r.metrics.cpu())
    assert launches == {"cpu": 0, "cuda": 22 if fn.endswith("ized") else 21}
    (rc, pc, lc, mc), (rg, pg, lg, mg_) = res["cpu"], res["cuda"]
    assert bool(rc.success) and bool(rg.success)
    if dtype == torch.float32:
        assert float((pg - pc).abs().max()) <= 1e-4
        assert float((lg - lc).abs().max()) <= 1e-3 * float(lc.abs().max())
    else:
        assert int(rc.iterations) == int(rg.iterations)
        assert int(rc.status) == int(rg.status)
        assert float((pg - pc).abs().max()) <= 1e-9
        cols = [0, 1, 2, 3, 5]
        np.testing.assert_allclose(mg_[:, cols].numpy(), mc[:, cols].numpy(),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(mg_[:, 4].numpy(), mc[:, 4].numpy(),
                                   rtol=1e-4, atol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["vo", "vio"])
def test_compiled_steps_with_ba_assemble_bitwise_eager(dev, kind):
    """The compiled VO and VIO steps (K3 inside their graphs, its launches
    carried over replays) against the eager steps over 30 frames of the
    small scene with the chi^2 gate and the observation weights on: poses
    bit for bit, and as many K3 calls, at least one solve's."""
    from rsvio_tpu_torch.models import estimator_vio as ev
    from rsvio_tpu_torch.ops.cuda import ba_kernel

    base, frames, shape = _small_scene(30)
    base = base._replace(ba=base.ba._replace(chi2_gate=0.02),
                         use_obs_weights=True)
    rig = bench_scene.make_rig(dev, shape=shape, fx=100.0)
    frames_d = [(a.to(dev), b.to(dev)) for a, b in frames]
    poses, launches = {}, {}
    for name in ("eager", "compiled"):
        if kind == "vo":
            step = (est.make_compiled_estimator_step(base, device=dev)
                    if name == "compiled" else est.make_estimator_step(base))
            state = est.init_state(base, device=dev)
        else:
            cfg = _vio_cfg(base)
            cfg = cfg._replace(vio=cfg.vio._replace(chi2_gate=0.02))
            step = (ev.make_compiled_vio_estimator_step(cfg, device=dev)
                    if name == "compiled" else ev.make_vio_estimator_step(cfg))
            state = ev.init_vio_state(cfg, device=dev)
        torch.cuda.synchronize()
        before = ba_kernel.ba_assemble.launches
        poses[name] = []
        for a, b in frames_d:
            extra = _hover_imu() if kind == "vio" else ()
            state, out = step(state, rig, a, b, *extra)
            poses[name].append(out.T_W_B.clone())
        torch.cuda.synchronize()
        launches[name] = ba_kernel.ba_assemble.launches - before
    assert launches["compiled"] == launches["eager"] >= 21, launches
    for k, (pe, pc) in enumerate(zip(poses["eager"], poses["compiled"])):
        assert torch.equal(pe, pc), (k, float((pe - pc).abs().max()))
