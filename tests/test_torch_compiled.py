"""The compiled VO step (make_compiled_estimator_step, the port's counterpart
of ``jax.jit(step)``) on the CPU, where its segments run eagerly over the
same fixed buffers, against the eager step and the JAX package's jitted
step.

Setup: tests/test_torch_estimator.py's 96x128 rolling-image sequence and
configuration (32 slots, 3 levels, window 4), 10 frames, three configs:
the default; the adaptive set of tests/test_torch_options.py (RANSAC gate
with K = 8 and JAX's Gumbel draws injected, the health-driven motion prior
and window weights); use_marginalization. Each sequence passes through all
five segment variants: segment M without and with PnP (frame 0, then every
frame), segment K without a keyframe, with a keyframe before the window
solve engages (frame 0) and with the solve. The JAX step uses its Pallas
KLT kernel in interpret mode.

Tolerances:
  * compiled against eager: every tensor of the state and output equal,
    bit for bit, every frame.
  * compiled against JAX: that file's (flags and counts equal, T_W_B
    within POSE_TOL = 1e-3 m / rad each frame; one step from a converted
    JAX state within STEP_TOL = 1e-4), health within 1e-4.
"""

import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from rsvio_tpu.models import estimator as jest
from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.utils import checkpoint, convert
from rsvio_tpu_torch.utils.graphs import Slab, leaves
from test_torch_estimator import (FLAGS, POSE_TOL, _compare_states, _frames,
                                  _jax_cfg, _jax_rig, _np, _pose_err,
                                  _torch_cfg)
from test_torch_options import _jax_draws, _option_sets

torch.set_num_threads(2)

HEALTH_TOL = 1e-4
VARIANTS = {("motion", False), ("motion", True), ("opt", False, False),
            ("opt", True, False), ("opt", True, True)}


def _configs():
    """name -> (JAX config, port config)."""
    adaptive = _option_sets()["adaptive"]
    return {
        "default": (_jax_cfg(), _torch_cfg()),
        "adaptive": adaptive[:2],
        "marg": (_jax_cfg()._replace(use_marginalization=True),
                 _torch_cfg()._replace(use_marginalization=True)),
    }


def _draws(cfg_t):
    if cfg_t.pnp.ransac_hypotheses <= 0:
        return test_.gumbel_draws
    d = _jax_draws(len(_frames()))
    return lambda fid, shape, dtype, device: torch.from_numpy(d[fid]).to(
        dtype=dtype, device=device)


def _rig():
    return convert.rig_from_numpy(_np(_jax_rig()), device="cpu")


def _clone(tree):
    return [t.clone() for t in leaves(tree)]


def _run(name):
    """Both JAX's and the port's (eager and compiled) runs of a config:
    per frame the JAX states and outputs (numpy), the eager and compiled
    states and outputs (cloned leaves), the compiled step's host mirror and
    segment variants."""
    cfg_j, cfg_t = _configs()[name]
    frames = _frames()
    step_j = jest.make_estimator_step(cfg_j)
    state = jest.init_state(cfg_j)
    j_states, j_outs = [_np(state)], []
    for a, b in frames:
        state, out = step_j(state, _jax_rig(), jnp.asarray(a),
                            jnp.asarray(b))
        j_states.append(_np(state))
        j_outs.append(_np(out))
    rig = _rig()
    eager = test_.make_estimator_step(cfg_t, draws=_draws(cfg_t))
    comp = test_.make_compiled_estimator_step(cfg_t, draws=_draws(cfg_t),
                                              device="cpu")
    se = sc = test_.init_state(cfg_t, device="cpu")
    r = dict(cfg=cfg_t, comp=comp, j_states=j_states, j_outs=j_outs,
             eager=[], compiled=[], outs=[], mirror=[], variants=[],
             device=[])
    for a, b in frames:
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        kf_in = int(sc.kf_count)
        se, oe = eager(se, rig, a, b)
        sc, oc = comp(sc, rig, a, b)
        r["eager"].append(_clone((se, oe)))
        r["compiled"].append(_clone((sc, oc)))
        r["outs"].append(test_.FrameOutput(*(t.clone() for t in oc)))
        r["mirror"].append(comp.mirror)
        r["device"].append((int(sc.frame_id), int(sc.kf_count),
                            bool(oc.is_keyframe)
                            and bool(test_.full_now(cfg_t,
                                                    torch.tensor(kf_in)))))
        r["variants"].append(comp.last_variants)
    return r


@pytest.fixture(scope="module")
def run_default():
    return _run("default")


@pytest.fixture(scope="module")
def run_adaptive():
    return _run("adaptive")


@pytest.fixture(scope="module")
def run_marg():
    return _run("marg")


NAMES = ["default", "adaptive", "marg"]


@pytest.mark.parametrize("name", NAMES)
def test_compiled_equals_eager_bitwise(request, name):
    """Every tensor of the state and output, every frame, through all five
    segment variants."""
    r = request.getfixturevalue(f"run_{name}")
    for k, (e, c) in enumerate(zip(r["eager"], r["compiled"])):
        assert len(e) == len(c)
        for i, (x, y) in enumerate(zip(e, c)):
            assert x.dtype == y.dtype and torch.equal(x, y), (k, i)
    assert {v for vs in r["variants"] for v in vs} == VARIANTS


@pytest.mark.parametrize("name", NAMES)
def test_compiled_matches_jax(request, name):
    """Flags, counts, health and pose per frame against JAX's jitted step."""
    r = request.getfixturevalue(f"run_{name}")
    saw_ba = False
    for k, (ot, oj) in enumerate(zip(r["outs"], r["j_outs"])):
        for f in FLAGS + ("n_ransac_inliers", "n_pnp_candidates"):
            assert int(getattr(ot, f)) == int(getattr(oj, f)), (k, f)
        dt, dr = _pose_err(ot.T_W_B.numpy(), oj.T_W_B)
        assert dt <= POSE_TOL and dr <= POSE_TOL, (k, dt, dr)
        assert abs(float(ot.health) - float(oj.health)) <= HEALTH_TOL, k
        saw_ba = saw_ba or bool(ot.ba_success)
    assert saw_ba and float(ot.T_W_B[0, 3]) > 0.05


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["keyframe_with_ba", "non_keyframe"])
def test_one_compiled_step_from_jax_state(request, name, kind):
    """The compiled step handed JAX's state before frame k (a state it did
    not produce: it loads it and reads its mirror from it) steps to JAX's
    state after frame k."""
    r = request.getfixturevalue(f"run_{name}")
    outs = r["j_outs"]
    want = {"keyframe_with_ba": lambda o: bool(o.is_keyframe & o.ba_success),
            "non_keyframe": lambda o: not bool(o.is_keyframe)}[kind]
    k = [k for k in range(2, len(outs)) if want(outs[k])][0]
    state = convert.state_from_numpy(r["j_states"][k], device="cpu")
    a, b = _frames()[k]
    comp = r["comp"]
    new, out = comp(state, _rig(), torch.from_numpy(a), torch.from_numpy(b))
    assert comp.mirror == (k + 1, int(r["j_states"][k + 1].kf_count))
    for f in FLAGS:
        assert int(getattr(out, f)) == int(getattr(outs[k], f)), f
    _compare_states(convert.state_to_numpy(new), r["j_states"][k + 1])


@pytest.mark.parametrize("name", NAMES)
def test_host_mirror_equals_device(request, name):
    """After every frame the mirror's (frame_id, kf_count) are the device
    state's, and the keyframe stage's solve flag is the device's full_now."""
    r = request.getfixturevalue(f"run_{name}")
    for k, (mirror, dev, variants) in enumerate(
            zip(r["mirror"], r["device"], r["variants"])):
        assert mirror == dev[:2], k
        assert variants[1][2] == dev[2], k


def test_host_mirror_after_checkpoint_resume(run_marg, tmp_path):
    """A checkpoint written after frame 5 and loaded into a fresh compiled
    step resumes bit for bit: the mirror is read from the loaded state and
    the following frames equal the uninterrupted run's."""
    cfg = run_marg["cfg"]
    frames = [(torch.from_numpy(a), torch.from_numpy(b))
              for a, b in _frames()]
    step = test_.make_compiled_estimator_step(cfg, device="cpu")
    state = test_.init_state(cfg, device="cpu")
    rig = _rig()
    for a, b in frames[:6]:
        state, _ = step(state, rig, a, b)
    path = str(tmp_path / "s.ckpt")
    checkpoint.save_state(path, state)
    resumed = test_.make_compiled_estimator_step(cfg, device="cpu")
    state = checkpoint.load_state(path, test_.init_state(cfg, device="cpu"))
    for k in range(6, len(frames)):
        state, out = resumed(state, rig, *frames[k])
        assert resumed.mirror == (int(state.frame_id), int(state.kf_count))
        for x, y in zip(leaves((state, out)), run_marg["compiled"][k]):
            assert torch.equal(x, y), k


def test_returned_state_survives_the_next_call():
    """Ping-pong outputs: what call k returned is unchanged by call k + 1,
    and call k + 2 reuses its buffers."""
    cfg = _torch_cfg()
    step = test_.make_compiled_estimator_step(cfg, device="cpu")
    state = test_.init_state(cfg, device="cpu")
    rig = _rig()
    frames = [(torch.from_numpy(a), torch.from_numpy(b))
              for a, b in _frames()[:4]]
    s1, o1 = step(state, rig, *frames[0])
    before = _clone((s1, o1))
    s2, _ = step(s1, rig, *frames[1])
    assert all(torch.equal(x, y) for x, y in zip(leaves((s1, o1)), before))
    s3, _ = step(s2, rig, *frames[2])
    assert s3.T_W_B.data_ptr() == s1.T_W_B.data_ptr()
    assert s2.T_W_B.data_ptr() != s1.T_W_B.data_ptr()


class _Guard:
    """Tensor.__bool__ / item / tolist / __int__ / __float__, and indexing
    with a 0-d tensor (which reads it on the host), raise while a segment
    runs, except inside the plain KLT versions (ops/cuda/klt_kernel.py),
    the CPU's stand-ins for the kernels, whose early exits read the device;
    on the card the kernels run instead."""
    NAMES = ("__bool__", "item", "tolist", "__int__", "__float__")

    def __init__(self, monkeypatch):
        self.active, self.calls = False, 0
        for n in self.NAMES:
            monkeypatch.setattr(torch.Tensor, n, self._wrap(
                n, getattr(torch.Tensor, n)))
        for n in ("__getitem__", "__setitem__"):
            monkeypatch.setattr(torch.Tensor, n, self._wrap_index(
                n, getattr(torch.Tensor, n)))

    def _watched(self):
        return self.active and not sys._getframe(2).f_code.co_filename \
            .endswith("klt_kernel.py")

    def _wrap(self, name, orig):
        def f(t, *a, **k):
            if self._watched():
                raise AssertionError(f"Tensor.{name} inside a segment")
            return orig(t, *a, **k)
        return f

    def _wrap_index(self, name, orig):
        def f(t, index, *a):
            idx = index if isinstance(index, tuple) else (index,)
            if self._watched() and any(
                    isinstance(i, torch.Tensor) and i.dim() == 0
                    for i in idx):
                raise AssertionError(f"Tensor.{name} with a 0-d tensor "
                                     "index inside a segment")
            return orig(t, index, *a)
        return f

    def wrap(self, fn):
        """`fn` watched while it runs."""
        def g(*a, **k):
            self.active, self.calls = True, self.calls + 1
            try:
                return fn(*a, **k)
            finally:
                self.active = False
        return g

    def segments(self, sg):
        """A step's segments (a NamedTuple of functions), each watched."""
        return type(sg)(*(self.wrap(fn) for fn in sg))


@pytest.mark.parametrize("name", NAMES)
def test_segments_read_nothing_from_the_device(monkeypatch, name):
    """No segment reads a tensor on the host: the compiled step's only
    reads are its mirror (first call) and is_kf (every frame)."""
    cfg = _configs()[name][1]
    step = test_.make_compiled_estimator_step(cfg, draws=_draws(cfg),
                                              device="cpu")
    guard = _Guard(monkeypatch)
    step._sg = guard.segments(step._sg)
    state = test_.init_state(cfg, device="cpu")
    rig = _rig()
    for a, b in _frames()[:7]:
        state, out = step(state, rig, torch.from_numpy(a),
                          torch.from_numpy(b))
    assert guard.calls == 14
    assert step.host_reads == 7


def test_probe_is_refused():
    """A probe's dict counts cannot be replayed from a graph."""
    with pytest.raises(ValueError, match="probe"):
        test_.make_compiled_estimator_step(_torch_cfg(), device="cpu",
                                           probe={})


def test_foreign_layout_raises():
    """A state of another layout than the first one (another capacity)
    raises instead of being copied in part."""
    cfg = _torch_cfg()
    step = test_.make_compiled_estimator_step(cfg, device="cpu")
    rig = _rig()
    a, b = (torch.from_numpy(x) for x in _frames()[0])
    step(test_.init_state(cfg, device="cpu"), rig, a, b)
    other = cfg._replace(frontend=cfg.frontend._replace(capacity=16))
    with pytest.raises(ValueError):
        step(test_.init_state(other, device="cpu"), rig, a, b)


def test_slab_layout():
    """Views of one buffer at 256-byte boundaries; a prefix layout copies
    with one copy_."""
    tree = (torch.arange(3, dtype=torch.float64), {"b": torch.ones(
        2, 2, dtype=torch.bool)}, None, (torch.tensor(7, dtype=torch.int32),))
    s = Slab(tree, "cpu")
    s.load(tree)
    assert [o for o, _, _ in s.specs] == [0, 256, 512]
    assert torch.equal(s.tree[0], tree[0]) and s.tree[2] is None
    assert s.tree[1]["b"].dtype == torch.bool and int(s.tree[3][0]) == 7
    t = Slab(tree[:2], "cpu")
    assert t.same_prefix(s) and not s.same_prefix(t)
    t.buf.copy_(s.buf[:t.nbytes])
    assert torch.equal(t.tree[0], tree[0])
