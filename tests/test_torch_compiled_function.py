"""utils.graphs.compile_function (the port's counterpart of ``jax.jit`` for a
function with fixed shapes and no host branch) and the counters Graphs
carries over replays, on the CPU.

* On the CPU the compiled function runs `fn` eagerly over its fixed
  buffers: its results are bit for bit fn's (solve_ba, solve_pnp on
  tests/test_torch_solvers.py's problems), and they come back in the
  layout's output buffer, which the next call of that layout overwrites.
* compile_function(solve_ba) against the JAX package's jitted solve_ba
  (``@partial(jax.jit, ...)``, rsvio_tpu/models/ba.py) on the same arrays,
  at tests/test_torch_solvers.py's tolerances (float32: equal success,
  poses within 1e-4, landmarks within 1e-3 relative; float64: the same LM
  path, metrics within 1e-6 relative).
* A new argument layout makes a new variant; the old one is reused.
* Counters: Graphs' first use of a variant runs it once and captures it
  (the capture's counter moves undone), and each replay advances the
  counters by what the capture recorded — (object, attribute) pairs and a
  dict's items (Mesh.counts). The CUDA calls of the capture are stood in
  for here (a graph whose replay runs nothing), so only the carry-over is
  at work: after N runs the counts are N runs' worth. On a card the same
  is held by the gpu tests (tests/test_torch_gpu.py).
"""

import contextlib
import os
import sys
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rsvio_tpu.models import ba as jba
from rsvio_tpu_torch.models import ba as tba
from rsvio_tpu_torch.models import pnp as tpnp
from rsvio_tpu_torch.utils import graphs
from rsvio_tpu_torch.utils.graphs import compile_function

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_solvers import (_check, _noisy, _run, ba_problem,  # noqa: E402
                                pnp_problem, tt)

torch.set_num_threads(2)


def _ba_inputs(seed=0, w=5):
    T_init, T_C_B, lms, obs, mask, lm_valid, _, _ = ba_problem(seed=seed, w=w)
    obs = _noisy(obs, mask, 3)
    return [T_init, T_C_B, lms, obs, mask, lm_valid]


def _pnp_inputs(seed=21):
    T_init, T_C_B, p_W, obs, mask, _ = pnp_problem(seed=seed)
    return [T_init, T_C_B, p_W, _noisy(obs, mask, 1), mask]


def _leaves_equal(a, b):
    la, lb = graphs.leaves(a), graphs.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("name", ["solve_ba", "solve_pnp"])
def test_compiled_function_bitwise_on_cpu(name):
    fn, inputs = {"solve_ba": (tba.solve_ba, _ba_inputs),
                  "solve_pnp": (tpnp.solve_pnp, _pnp_inputs)}[name]
    cf = compile_function(fn, "cpu")
    firsts = []
    for seed in (0, 1, 2):
        args = [tt(a) for a in inputs(seed=seed)]
        got = cf(*args)
        _leaves_equal(got, fn(*args))
        firsts.append(got)
    # One layout, one variant: each call came back in the same buffer.
    assert list(cf.graphs.uses.items()) == [(0, 3)]
    assert all(f.T_W_B is firsts[0].T_W_B for f in firsts)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_compiled_solve_ba_matches_jax(dtype):
    cfg = tba.BAConfig()

    def compiled(*a):
        return compile_function(partial(tba.solve_ba, cfg=a[-1]), "cpu")(
            *a[:-1])
    rt, rj = _run(dtype, jba.solve_ba, compiled, _ba_inputs(),
                  jba.BAConfig(), cfg)
    _check(rt, rj, dtype)
    lj = rj.landmarks
    np.testing.assert_allclose(rt.landmarks.numpy(), lj, rtol=1e-3,
                               atol=1e-3 * np.abs(lj).max())


def test_new_layout_makes_new_variant():
    cf = compile_function(tba.solve_ba, "cpu")
    w5, w4 = ([tt(a) for a in _ba_inputs(w=w)] for w in (5, 4))
    r5 = cf(*w5)
    assert tuple(r5.T_W_B.shape) == (5, 4, 4)
    r4 = cf(*w4)
    assert tuple(r4.T_W_B.shape) == (4, 4, 4)
    again = cf(*w5)
    assert again.T_W_B is r5.T_W_B
    assert cf.graphs.uses == {0: 2, 1: 1}
    _leaves_equal(again, tba.solve_ba(*w5))
    # A dtype is part of the layout too.
    cf(*[a.double() if a.is_floating_point() else a for a in w4])
    assert cf.graphs.uses == {0: 2, 1: 1, 2: 1}


class _FakeGraph:
    """A stand-in CUDA graph: its replay runs nothing, as a real replay runs
    no Python."""
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


def _stand_in_capture(monkeypatch):
    class Stream:
        def wait_stream(self, other):
            pass
    for name, value in (
            ("Stream", lambda device=None: Stream()),
            ("current_stream", lambda device=None: Stream()),
            ("get_sync_debug_mode", lambda: 0),
            ("set_sync_debug_mode", lambda mode: None),
            ("stream", lambda s: contextlib.nullcontext()),
            ("CUDAGraph", _FakeGraph),
            ("graph", lambda g, **kw: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, value)


def test_counters_carried_over_replays(monkeypatch):
    _stand_in_capture(monkeypatch)
    counts = dict(all_reduce_calls=0, all_reduce_bytes=0, untouched=0)
    kernel = SimpleNamespace(launches=0)
    runs = []

    def fn():
        runs.append(1)
        counts["all_reduce_calls"] += 3
        counts["all_reduce_bytes"] += 3 * 16344
        kernel.launches += 2

    g = graphs.Graphs(torch.device("cuda"), ((kernel, "launches"), counts))
    _FakeGraph.replays = 0
    for n in range(1, 6):
        g.run("solve", fn)
        assert counts == dict(all_reduce_calls=3 * n,
                              all_reduce_bytes=3 * 16344 * n, untouched=0)
        assert kernel.launches == 2 * n
    # The first use ran fn twice (its eager run and the capture), every
    # later use replayed the graph.
    assert len(runs) == 2 and g.replays == 4 == _FakeGraph.replays
    assert g.uses == {"solve": 5}


def test_compiled_function_counters_on_cpu():
    counts = dict(calls=0)

    def fn(x):
        counts["calls"] += 1
        return x * 2.0
    cf = compile_function(fn, "cpu", (counts,))
    for _ in range(4):
        out = cf(torch.arange(3.0))
    assert counts == {"calls": 4}
    assert torch.equal(out, torch.tensor([0.0, 2.0, 4.0]))
