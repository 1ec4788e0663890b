"""The compiled mono step (make_compiled_mono_step, the port's counterpart of
the JAX package's jitted ``mono_tracker_step``) on the CPU, where the same
pyramid build and step run eagerly over its fixed buffers, against the
eager ``mono_tracker_step`` and JAX's jitted one.

Setup: tests/test_torch_tracker_paths.py's mono tracker (the
config/tartanair.yaml settings cut to a 3-level 72x104 image, 32 slots, 10
iterations; a ratio-0.5 pyramid blurred at sigma 2) over 10 rendered frames
1.4 px apart, in NMS and grid detection. The JAX step's KLT runs its Pallas
kernel in interpret mode.

Tolerances: compiled against eager, every tensor of the table and the
counts equal, bit for bit, every frame; against JAX, that file's (every
integer table field and the counts equal, positions within 1e-3 px, warps
within 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import mono_tracker as jmono
from rsvio_tpu.ops import pyramid as jpyr
from rsvio_tpu_torch.models import mono_tracker as tmono
from rsvio_tpu_torch.ops import pyramid as tpyr
from rsvio_tpu_torch.utils.graphs import leaves
from test_torch_compiled import _Guard
from test_torch_tracker_paths import A_TOL, POS_TOL, _mono_cfgs, _views

torch.set_num_threads(2)

N_FRAMES = 10
MODES = ["nms", "grid"]


def make_pyramid(img):
    return tpyr.build_pyramid_ratio(img, 3, 0.5, blur=True, blur_sigma=2.0)


def _images():
    return [torch.from_numpy(x) for x in
            _views(20, [0.012 * k for k in range(N_FRAMES)])]


def _run(mode):
    """Per frame the eager and the compiled step's (table, stats) leaves
    and pyramids, cloned."""
    cfg = _mono_cfgs(mode)[1]
    step = tmono.make_compiled_mono_step(cfg, make_pyramid, device="cpu")
    te = tc = tmono.init_mono_table(cfg.capacity, device="cpu")
    prev = None
    r = {"eager": [], "compiled": [], "pyr_e": [], "pyr_c": [], "step": step}
    for k, img in enumerate(_images()):
        pyr = make_pyramid(img)
        te, se = tmono.mono_tracker_step(te, pyr if k == 0 else prev, pyr,
                                         cfg, first_frame=k == 0)
        prev = pyr
        tc, sc = step(tc, img, first_frame=k == 0)
        r["eager"].append([t.clone() for t in leaves((te, se))])
        r["compiled"].append([t.clone() for t in leaves((tc, sc))])
        r["pyr_e"].append(pyr)
        r["pyr_c"].append([lvl.clone() for lvl in step.pyramid])
    return r


@pytest.fixture(scope="module")
def runs():
    return {m: _run(m) for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_compiled_mono_equals_eager_bitwise(runs, mode):
    """Table, counts and the pyramid, every frame, through both variants."""
    r = runs[mode]
    for k in range(N_FRAMES):
        for i, (x, y) in enumerate(zip(r["eager"][k], r["compiled"][k])):
            assert x.dtype == y.dtype and torch.equal(x, y), (k, i)
        for x, y in zip(r["pyr_e"][k], r["pyr_c"][k]):
            assert torch.equal(x, y), k
    step = r["step"]
    assert step.graphs.uses == {("mono", True): 1,
                                ("mono", False): N_FRAMES - 1}
    assert step.host_reads == 0
    assert min(int(c[-2]) for c in r["compiled"][1:]) >= 8


@pytest.mark.parametrize("mode", MODES)
def test_compiled_mono_matches_jax(mode):
    """The compiled step against JAX's jitted mono_tracker_step."""
    cj, ct = _mono_cfgs(mode)
    step = tmono.make_compiled_mono_step(ct, make_pyramid, device="cpu")
    tj = jmono.init_mono_table(ct.capacity)
    tt_ = tmono.init_mono_table(ct.capacity, device="cpu")
    prev_j = None
    for k, img in enumerate(_images()):
        pj = jpyr.build_pyramid_ratio(jnp.asarray(img.numpy()), 3, 0.5,
                                      blur=True, blur_sigma=2.0)
        first = k == 0
        tj, sj = jmono.mono_tracker_step(tj, pj if first else prev_j, pj, cj,
                                         first_frame=first)
        prev_j = pj
        tt_, st = step(tt_, img, first_frame=first)
        for f in ("alive", "fid", "age", "next_id"):
            np.testing.assert_array_equal(getattr(tt_, f).numpy(),
                                          np.asarray(getattr(tj, f)),
                                          err_msg=f"frame {k} {f}")
        np.testing.assert_allclose(tt_.pos.numpy(), np.asarray(tj.pos),
                                   rtol=0, atol=POS_TOL)
        np.testing.assert_allclose(tt_.A.numpy(), np.asarray(tj.A), rtol=0,
                                   atol=A_TOL)
        for f in ("tracked", "alive"):
            assert int(st[f]) == int(sj[f]), (k, f)


def test_compiled_mono_reads_nothing_from_the_device(monkeypatch):
    """No Tensor.__bool__ / item / tolist or 0-d tensor index while the
    step runs (the plain KLT version, the CPU's stand-in for the kernel,
    exempt)."""
    cfg = _mono_cfgs("nms")[1]
    step = tmono.make_compiled_mono_step(cfg, make_pyramid, device="cpu")
    guard = _Guard(monkeypatch)
    frame = step._frame
    step._frame = lambda first_frame: guard.wrap(frame(first_frame))
    table = tmono.init_mono_table(cfg.capacity, device="cpu")
    for k, img in enumerate(_images()[:4]):
        table, _ = step(table, img, first_frame=k == 0)
    assert guard.calls == 4 and step.host_reads == 0


def test_compiled_mono_needs_a_first_frame():
    """Without a previous pyramid the step refuses first_frame=False; a
    table it did not return is copied in; outputs alternate between two
    buffers."""
    cfg = _mono_cfgs("grid")[1]
    step = tmono.make_compiled_mono_step(cfg, make_pyramid, device="cpu")
    table = tmono.init_mono_table(cfg.capacity, device="cpu")
    imgs = _images()
    with pytest.raises(ValueError, match="first_frame"):
        step(table, imgs[0])
    t1, _ = step(table, imgs[0], first_frame=True)
    t2, _ = step(t1, imgs[1])
    t3, _ = step(t2, imgs[2])
    assert t3.pos.data_ptr() == t1.pos.data_ptr() != t2.pos.data_ptr()
    eager = tmono.mono_tracker_step(t2, make_pyramid(imgs[1]),
                                    make_pyramid(imgs[2]), cfg)[0]
    assert all(torch.equal(x, y) for x, y in zip(t3, eager))
    with pytest.raises(ValueError, match="detect_mode"):
        tmono.make_compiled_mono_step(cfg._replace(detect_mode="x"),
                                      make_pyramid, device="cpu")
