"""The compiled VIO step (make_compiled_vio_estimator_step, the port's
counterpart of the JAX package's jitted VIO step) on the CPU, where its
segments run eagerly over the same fixed buffers, against the eager step
and the JAX package's jitted step.

Setup: tests/test_torch_vio.py's scene (96x128 rolling-image sequence, 32
slots, 3 levels, window 4, 10 frames), its 16-slot hover IMU buffer and
``VIOBAConfig(max_iterations=10)``. Runs:

  * default, marg (use_marginalization) and gate (the RANSAC gate with 8
    hypotheses and JAX's Gumbel draws injected, the adaptive health's
    weights and the desert bias stiffness: tests/test_torch_vio_options.py's
    set) on the hover buffer (10 valid samples a frame);
  * saturate: interval_buf = 16, so the interval behind a frame without a
    keyframe overflows (20 samples), buf_count saturates and the interval
    goes invalid;
  * buckets: track_before_full=False (the window solve engages once the
    window is full) and 2-16 valid samples a frame, some with a hole, so
    segment F (with and without PnP) and segment P (the keyframe stage's
    prologue, before segment K with and without the solve) each run at two
    or more loop bounds.

The JAX step uses its Pallas KLT kernel in interpret mode.

Tolerances:
  * compiled against eager: every tensor of the state and output equal,
    bit for bit, every frame.
  * compiled against JAX: tests/test_torch_vio.py's (flags and counts
    equal; poses 3e-3 m / rad, velocity 1e-2 m/s, biases 5e-3 each frame;
    one step from a converted JAX state: integers equal, floats 1e-4).
"""

import copy

import numpy as np
import pytest
import torch

from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.models import estimator_vio as tev
from rsvio_tpu_torch.models import imu
from rsvio_tpu_torch.utils import checkpoint, convert
from rsvio_tpu_torch.utils.graphs import leaves, rebuild
from test_torch_compiled import _Guard
from test_torch_estimator import FLAGS, _frames, _jax_rig, _np
from test_torch_vio import (_compare_states, assert_sequence_matches,
                            imu_buffer, jax_draws, run_jax, vio_cfgs)
from test_torch_vio_options import GATE, K_HYP

torch.set_num_threads(2)

NAMES = ["default", "marg", "gate", "saturate", "buckets"]
# The buckets run's valid samples a frame (of 16); odd frames lose sample 1.
COUNTS = [5, 12, 3, 14, 9, 16, 6, 11, 2, 13]


def _cfg(name):
    kw = {"default": {}, "saturate": {}, "marg": dict(use_marginalization=True),
          "gate": copy.deepcopy(GATE),
          "buckets": dict(track_before_full=False)}[name]
    cfg = vio_cfgs(**kw)[1]
    return cfg._replace(interval_buf=16) if name == "saturate" else cfg


def _draws(name):
    if name != "gate":
        return test_.gumbel_draws
    d = jax_draws(len(_frames()), K_HYP)
    return lambda fid, shape, dtype, device: torch.from_numpy(d[fid]).to(
        dtype=dtype, device=device)


def _imu(name, k):
    if name != "buckets":
        return imu_buffer()
    gyro, accel, dts, mask = imu_buffer(n=COUNTS[k])
    if k % 2:
        mask[1] = False
    return gyro, accel, dts, mask


def _rig():
    return convert.rig_from_numpy(_np(_jax_rig()), device="cpu")


def _clone(tree):
    return [t.clone() for t in leaves(tree)]


def _device_mirror(state):
    return (int(state.frame_id), int(state.kf_count), int(state.buf_count))


def _run(name):
    """The eager and the compiled step over the frames: per frame both
    steps' states and outputs (cloned leaves), the compiled step's mirror,
    the device state's (frame_id, kf_count, buf_count), the keyframe
    stage's device full_now and the segment variants."""
    cfg = _cfg(name)
    rig = _rig()
    eager = tev.make_vio_estimator_step(cfg, draws=_draws(name))
    comp = tev.make_compiled_vio_estimator_step(cfg, draws=_draws(name),
                                                device="cpu")
    se = sc = tev.init_vio_state(cfg, device="cpu")
    r = dict(cfg=cfg, comp=comp, eager=[], compiled=[], mirror=[],
             device=[], full_now=[], variants=[], states=[])
    for k, (a, b) in enumerate(_frames()):
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        kf_in = sc.kf_count.clone()
        se, oe = eager(se, rig, a, b, *_imu(name, k))
        sc, oc = comp(sc, rig, a, b, *_imu(name, k))
        r["eager"].append(_clone((se, oe)))
        r["compiled"].append(_clone((sc, oc)))
        r["states"].append(rebuild(sc, iter(r["compiled"][-1])))
        r["mirror"].append(comp.mirror)
        r["device"].append(_device_mirror(sc))
        r["full_now"].append(bool(oc.is_keyframe) and bool(
            test_.full_now(cfg.base, kf_in)))
        r["variants"].append(comp.last_variants)
    return r


@pytest.fixture(scope="module")
def runs():
    return {}


def _get(runs, name):
    if name not in runs:
        runs[name] = _run(name)
    return runs[name]


@pytest.mark.parametrize("name", NAMES)
def test_compiled_vio_equals_eager_bitwise(runs, name):
    """Every tensor of the state and output, every frame."""
    r = _get(runs, name)
    for k, (e, c) in enumerate(zip(r["eager"], r["compiled"])):
        assert len(e) == len(c)
        for i, (x, y) in enumerate(zip(e, c)):
            assert x.dtype == y.dtype and torch.equal(x, y), (k, i)
    kinds = {v[:1] if v[0] == "kf_pre" else v[:2]
             for vs in r["variants"] for v in vs if v}
    assert kinds >= {("front", False), ("front", True), ("kf_pre",),
                     ("kf", False), ("kf", True)}, kinds


@pytest.mark.parametrize("name", NAMES)
def test_vio_host_mirror_equals_device(runs, name):
    """After every frame the mirror's (frame_id, kf_count, buf_count) are
    the device state's, and the keyframe variant's solve flag is the
    device's full_now."""
    r = _get(runs, name)
    for k, (mirror, dev, full, (_, pre, kf)) in enumerate(zip(
            r["mirror"], r["device"], r["full_now"], r["variants"])):
        assert mirror == dev, k
        assert (pre is not None) == kf[1], k
        assert (kf[1] and kf[2]) == full, k


def test_every_variant_at_two_bounds(runs):
    """The buckets run meets segment F with and without PnP at two or more
    frame loop bounds each, and segment P at two or more interval loop
    bounds before segment K with a keyframe before the window solve engages
    and before K with the solve; and K without a keyframe."""
    r = _get(runs, "buckets")
    met = {}
    for front, pre, kf in r["variants"]:
        met.setdefault(front[:2], set()).add(front[2])
        met.setdefault(kf, set()).add(pre and pre[1])
    for kind in (("front", False), ("front", True), ("kf", True, False),
                 ("kf", True, True)):
        assert len(met.get(kind, ())) >= 2, (kind, met)
    assert met.get(("kf", False)) == {None}, met


def test_saturated_interval_goes_invalid(runs):
    """interval_buf = 16: a keyframe after a frame without one closes an
    interval of 20 samples; the buffer saturates at 16 (the mirror and the
    state agree), its loop runs at the cap, the interval is invalid."""
    r = _get(runs, "saturate")
    closes = [k for k, (_, pre, _) in enumerate(r["variants"])
              if pre and k > 0 and not r["variants"][k - 1][1]]
    assert closes, r["variants"]
    for k in closes:
        assert r["variants"][k][1] == ("kf_pre", 16)
        assert r["mirror"][k - 1][2] + 10 > 16
    st = r["states"][closes[0]]
    slot = min(int(st.kf_count), 4) - 2
    assert not bool(st.kf_preint_valid[slot])
    default = _get(runs, "default")["states"][closes[0]]
    assert bool(default.kf_preint_valid[slot])


@pytest.mark.parametrize("name", ["default", "marg", "gate"])
def test_vio_segments_read_nothing_from_the_device(monkeypatch, name):
    """No segment (F, P on keyframes, K) reads a tensor on the host: the
    compiled step's only reads are its mirror (first call) and is_kf
    (every frame)."""
    cfg = _cfg(name)
    step = tev.make_compiled_vio_estimator_step(cfg, draws=_draws(name),
                                                device="cpu")
    guard = _Guard(monkeypatch)
    step._sg = guard.segments(step._sg)
    state = tev.init_vio_state(cfg, device="cpu")
    rig = _rig()
    n_kf = 0
    for k, (a, b) in enumerate(_frames()[:7]):
        state, out = step(state, rig, torch.from_numpy(a),
                          torch.from_numpy(b), *_imu(name, k))
        n_kf += bool(out.is_keyframe)
    assert guard.calls == 14 + n_kf and step.host_reads == 7


def test_vio_checkpoint_resume_rereads_the_mirror(runs, tmp_path):
    """A checkpoint written after frame 5 and loaded into a fresh compiled
    step resumes bit for bit: the mirror is read from the loaded state and
    the following frames equal the uninterrupted run's."""
    r = _get(runs, "marg")
    cfg = r["cfg"]
    frames = [(torch.from_numpy(a), torch.from_numpy(b))
              for a, b in _frames()]
    path = str(tmp_path / "s.ckpt")
    checkpoint.save_state(path, r["states"][5])
    resumed = tev.make_compiled_vio_estimator_step(cfg, device="cpu")
    state = checkpoint.load_state(path, tev.init_vio_state(cfg, device="cpu"))
    for k in range(6, len(frames)):
        state, out = resumed(state, _rig(), *frames[k], *imu_buffer())
        assert resumed.mirror == _device_mirror(state)
        for x, y in zip(leaves((state, out)), r["compiled"][k]):
            assert torch.equal(x, y), k


def test_vio_probe_is_refused():
    """A probe's dict counts cannot be replayed from a graph."""
    with pytest.raises(ValueError, match="probe"):
        tev.make_compiled_vio_estimator_step(_cfg("default"), device="cpu",
                                             probe={})


def test_loop_bound():
    """Powers of two from 8, capped at the buffer's length."""
    assert [tev.loop_bound(n, 64) for n in (0, 1, 8, 9, 16, 17, 63, 64)] \
        == [8, 8, 8, 16, 16, 32, 64, 64]
    assert [tev.loop_bound(n, 512) for n in (100, 300, 512)] \
        == [128, 512, 512]
    assert tev.loop_bound(3, 4) == 4 and tev.loop_bound(16, 16) == 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_preintegrate_at_a_bucketed_bound_is_bitwise(dtype):
    """preintegrate over a 512-slot interval buffer with 37 live samples
    (holes among them) at the exact bound, at its loop_bound (64) and over
    the whole buffer: every field bit for bit."""
    rng = np.random.default_rng(11)
    S, n = 512, 37
    t = [torch.from_numpy(x).to(dtype) for x in (
        rng.normal(0, 0.5, (S, 3)), rng.normal(0, 1.0, (S, 3)) + [0, 0, 9.81],
        np.full(S, 0.005))]
    mask = torch.from_numpy((np.arange(S) < n)
                            & (rng.uniform(size=S) > 0.2))
    mask[n - 1] = True
    bg, ba = (torch.from_numpy(rng.normal(0, s, 3)).to(dtype)
              for s in (0.01, 0.05))
    exact = imu.preintegrate(*t, mask, bg, ba, n_steps=n)
    for bound in (tev.loop_bound(n, S), None):
        other = imu.preintegrate(*t, mask, bg, ba, n_steps=bound)
        for f in imu.Preintegrated._fields:
            assert torch.equal(getattr(exact, f), getattr(other, f)), \
                (bound, f)


@pytest.fixture(scope="module")
def jax_default():
    return run_jax(vio_cfgs()[0], imu_buffer())


def test_compiled_vio_matches_jax(jax_default):
    """The compiled step over the sequence against JAX's jitted step."""
    cfg = _cfg("default")
    step = tev.make_compiled_vio_estimator_step(cfg, device="cpu")
    state = assert_sequence_matches(cfg, jax_default, imu_buffer(),
                                    step=step)
    assert float(state.vel[0]) > 0.1
    assert step.host_reads == len(_frames())


def test_one_compiled_vio_step_from_jax_state(jax_default):
    """The compiled step handed JAX's state before a frame without a
    keyframe (a state it did not produce: it loads it and reads its mirror
    from it) steps to JAX's state after that frame."""
    outs = jax_default["outs"]
    k = [k for k in range(4, len(outs)) if not bool(outs[k].is_keyframe)][0]
    state = convert.vio_state_from_numpy(jax_default["states"][k],
                                         device="cpu")
    step = tev.make_compiled_vio_estimator_step(_cfg("default"),
                                                device="cpu")
    a, b = _frames()[k]
    new, out = step(state, _rig(), torch.from_numpy(a), torch.from_numpy(b),
                    *imu_buffer())
    sj = jax_default["states"][k + 1]
    assert step.mirror == (k + 1, int(sj.kf_count), int(sj.buf_count))
    for f in FLAGS:
        assert int(getattr(out, f)) == int(getattr(outs[k], f)), f
    _compare_states(convert.vio_state_to_numpy(new), sj)
