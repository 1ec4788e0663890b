"""Double precision in the port (``precision: f64``).

The KLT kernels take float32 only, as the TPU kernel does (it writes
float32 whatever it is given). The port's kernel route therefore casts the
pyramids, positions and start angles to float32 where the route is chosen
(ops/klt.py) and casts the results back to the caller's dtype; everything
else in the step stays float64.

* The f64 step on the gather route (``backend="xla"``, plain float64 all
  the way) against the JAX step under x64, run in a subprocess so that the
  process-wide x64 flag does not leak into the suite (as tests/test_f64.py
  does): tests/test_torch_estimator.py's scene, flags and counts equal,
  poses within 1e-6 (both sides compute in float64; measured gap ~1e-12).
* The f64 kernel route on the CPU (the kernels' plain versions) against the
  same calls fed float32 inputs: equal ok, positions within 1e-5 px, float64
  results.
* config/euroc_vo_dynamic.yaml with ``precision: f64`` through the default
  (kernel) route at the file's own 752x480, two frames.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rsvio_tpu_torch.data import bench_scene
from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.ops import klt, pyramid
from rsvio_tpu_torch.utils import config as config_mod
from test_torch_estimator import FLAGS, _frames, _torch_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_POSE_TOL = 1e-6
N_F64 = 8


@pytest.fixture(scope="module")
def jax_x64_gather_run(tmp_path_factory):
    """The JAX step in float64 on the gather route over the first N_F64
    frames, run in a fresh interpreter with x64 on; its per-frame outputs
    (numpy) and the rig."""
    out = tmp_path_factory.mktemp("x64") / "run.npz"
    prog = textwrap.dedent(f"""
        import os, sys
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["JAX_ENABLE_X64"] = "1"
        sys.path[:0] = [{REPO!r}, {os.path.join(REPO, "tests")!r}]
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        import numpy as np
        from rsvio_tpu.models import estimator as jest
        from test_torch_estimator import _frames, _jax_cfg, _jax_rig
        cfg = _jax_cfg()
        cfg = cfg._replace(frontend=cfg.frontend._replace(
            klt=cfg.frontend.klt._replace(backend="xla")))
        rig = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                     _jax_rig())
        step = jest.make_estimator_step(cfg)
        state = jest.init_state(cfg, dtype=jnp.float64)
        rec = {{}}
        for k, (a, b) in enumerate(_frames()[:{N_F64}]):
            state, o = step(state, rig, jnp.asarray(a, jnp.float64),
                            jnp.asarray(b, jnp.float64))
            for f in o._fields:
                rec.setdefault(f, []).append(np.asarray(getattr(o, f)))
        np.savez({str(out)!r}, rig_params=np.asarray(rig.params),
                 rig_T_C_B=np.asarray(rig.T_C_B),
                 rig_T_B_C=np.asarray(rig.T_B_C),
                 **{{f: np.stack(v) for f, v in rec.items()}})
    """)
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, f"{res.stdout}\n{res.stderr}"
    return dict(np.load(out))


def test_f64_gather_step_matches_jax_x64(jax_x64_gather_run):
    j = jax_x64_gather_run
    assert j["T_W_B"].dtype == np.float64
    cfg = _torch_cfg()
    cfg = cfg._replace(frontend=cfg.frontend._replace(
        klt=cfg.frontend.klt._replace(backend="xla")))
    rig = test_.CameraRig(*(torch.from_numpy(j[f"rig_{f}"])
                            for f in test_.CameraRig._fields))
    step = test_.make_estimator_step(cfg)
    state = test_.init_state(cfg, dtype=torch.float64, device="cpu")
    for k, (a, b) in enumerate(_frames()[:N_F64]):
        state, out = step(state, rig, torch.from_numpy(a).double(),
                          torch.from_numpy(b).double())
        assert out.T_W_B.dtype == torch.float64
        for f in FLAGS:
            assert int(getattr(out, f)) == int(j[f][k]), (k, f)
        np.testing.assert_allclose(out.T_W_B.numpy(), j["T_W_B"][k],
                                   rtol=0, atol=F64_POSE_TOL, err_msg=str(k))
    assert j["ba_success"].any()
    assert float(out.T_W_B[0, 3]) > 0.02


def _pyrs(dtype, levels=3):
    (a0, b0), (a1, b1) = _frames()[3], _frames()[4]
    return [pyramid.build_pyramid(torch.from_numpy(im).to(dtype), levels)
            for im in (a0, b0, a1, b1)]


@pytest.mark.parametrize("route", ["bidir_stereo", "track_points"])
def test_f64_kernel_route_matches_f32_inputs(route):
    """The kernel route (here the kernels' plain versions) with float64
    pyramids and positions: the same tracks as with float32 inputs, and
    float64 results."""
    cfg = klt.KLTConfig(levels=3, max_iterations=8)
    assert klt.resolve_backend(cfg) == "pallas"
    gen = torch.Generator().manual_seed(2)
    pos = torch.rand((40, 2), generator=gen, dtype=torch.float64) \
        * torch.tensor([104.0, 72.0], dtype=torch.float64) + 12.0
    alive = torch.ones(40, dtype=torch.bool)
    alive[::7] = False
    res = {}
    for dt in (torch.float64, torch.float32):
        p = _pyrs(dt)
        q = pos.to(dt)
        if route == "bidir_stereo":
            out = klt.track_points_bidirectional_stereo(
                p[0], p[1], p[2], p[3], q, q - 4.0, alive, cfg)
            res[dt] = (torch.cat([out[0], out[3]]),
                       torch.cat([out[1], out[4]]),
                       torch.cat([out[2], out[5]]))
        else:
            eye = torch.eye(2, dtype=dt).expand(40, 2, 2)
            res[dt] = klt.track_points(p[0], p[2], q, q, eye, alive, cfg)
    (p64, A64, ok64), (p32, A32, ok32) = res[torch.float64], res[torch.float32]
    assert p64.dtype == A64.dtype == torch.float64
    assert torch.equal(ok64, ok32) and int(ok64.sum()) >= 10
    assert float((p64 - p32.double()).abs().max()) <= 1e-5
    assert float((A64 - A32.double()).abs().max()) <= 1e-6
    # A failed or dead feature keeps the caller's exact float64 source.
    src = torch.cat([pos, pos - 4.0]) if route == "bidir_stereo" else pos
    assert torch.equal(p64[~ok64], src[~ok64])


def test_f64_config_runs_on_kernel_route():
    """config/euroc_vo_dynamic.yaml with precision: f64 on the default
    (kernel) route: two frames at 752x480, float64 out."""
    cfg = config_mod.load_config(os.path.join(REPO, "config",
                                              "euroc_vo_dynamic.yaml"))
    cfg.precision = "f64"
    ecfg, rig = config_mod.make_estimator_config(cfg, kind="vo",
                                                 device="cpu")
    assert klt.resolve_backend(ecfg.frontend.klt) == "pallas"
    assert rig.params.dtype == torch.float64
    step = test_.make_estimator_step(ecfg)
    state = test_.init_state(ecfg, dtype=torch.float64, device="cpu")
    tex = bench_scene.make_texture(0)
    kinds = (ecfg.cam_kind_l, ecfg.cam_kind_r)
    rig32 = test_.CameraRig(*(x.float() for x in rig))
    for k in range(2):
        a, b = bench_scene.render_rig(tex, rig32, kinds, k, ecfg.image_shape)
        state, out = step(state, rig, a.double(), b.double())
    assert out.T_W_B.dtype == torch.float64
    assert bool(torch.isfinite(out.T_W_B).all())
    assert int(out.n_tracked) >= 100 and int(out.n_alive) >= 100
