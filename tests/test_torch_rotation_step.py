"""The port's stereo VO step with ``KLTConfig(track_rotation=True)`` against
the JAX step: both KLT passes of every frame run the SE2 variant of the
fused kernel (K1-rot) — the JAX Pallas kernel in interpret mode, the port's
plain PyTorch version.

Setup as tests/test_torch_estimator.py (96x128, 32 slots, 3 levels, 8 KLT
iterations, window 4, the rolling-image stereo sequence), cut to 5 frames:
the interpreted rotation kernel is slow on the CPU. BA runs from the second
frame on.

Tolerance, as in the translation step test: per frame the keyframe / PnP /
BA flags and the track, landmark and occupancy counts equal; T_W_B within
1e-3 m and 1e-3 rad; the fed-back warps (table.A0, A1) within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.models import estimator as jest
from rsvio_tpu.models import frontend as jfe
from rsvio_tpu.ops import cameras as jcam
from rsvio_tpu.ops import klt as jklt
from rsvio_tpu_torch.models import estimator as test_
from rsvio_tpu_torch.models import frontend as tfe
from rsvio_tpu_torch.ops import klt as tklt
from rsvio_tpu_torch.utils import convert

torch.set_num_threads(2)

H, W = 96, 128
N_FRAMES = 5
POSE_TOL = 1e-3
A_TOL = 1e-4
FLAGS = ("is_keyframe", "pnp_success", "ba_success", "n_tracked",
         "n_landmarks", "n_alive", "pose_ok")


def _frames():
    rng = np.random.default_rng(0)
    tex = (np.kron(rng.uniform(0, 1, (H // 8, W // 8)), np.ones((8, 8))) * 140
           + np.kron(rng.uniform(0, 1, (H // 4, W // 4)), np.ones((4, 4))) * 70
           + 40).astype(np.float32)
    return [(np.roll(tex, -k, axis=1), np.roll(tex, -(k + 4), axis=1))
            for k in range(N_FRAMES)]


def _jax_rig():
    params = jcam.pack_params(jcam.PINHOLE_RADTAN, [100.0, 100.0, W / 2, H / 2],
                              [0, 0, 0, 0])
    return jest.make_rig(params, params, jnp.eye(4, dtype=jnp.float32),
                         jnp.eye(4, dtype=jnp.float32).at[0, 3].set(0.11))


@pytest.fixture(scope="module")
def jax_rot_run():
    cfg = jest.EstimatorConfig(
        frontend=jfe.FrontendConfig(
            capacity=32, cell_size=24, detect_margin=10,
            klt=jklt.KLTConfig(levels=3, max_iterations=8, backend="pallas",
                               track_rotation=True)),
        window_size=4, image_shape=(H, W))
    step = jest.make_estimator_step(cfg)
    rig = _jax_rig()
    state = jest.init_state(cfg)
    outs, tables = [], []
    for a, b in _frames():
        state, out = step(state, rig, jnp.asarray(a), jnp.asarray(b))
        outs.append(jax.tree_util.tree_map(np.asarray, out))
        tables.append(jax.tree_util.tree_map(np.asarray, state.table))
    return outs, tables, jax.tree_util.tree_map(np.asarray, rig)


def test_rotation_sequence_matches_jax(jax_rot_run):
    outs, tables, rig_np = jax_rot_run
    cfg = test_.EstimatorConfig(
        frontend=tfe.FrontendConfig(
            capacity=32, cell_size=24, detect_margin=10,
            klt=tklt.KLTConfig(levels=3, max_iterations=8,
                               track_rotation=True)),
        window_size=4, image_shape=(H, W))
    step = test_.make_estimator_step(cfg)
    rig = convert.rig_from_numpy(rig_np, device="cpu")
    state = test_.init_state(cfg, device="cpu")
    saw_ba = False
    for k, (a, b) in enumerate(_frames()):
        state, out = step(state, rig, torch.from_numpy(a),
                          torch.from_numpy(b))
        oj = outs[k]
        for f in FLAGS:
            assert int(getattr(out, f)) == int(getattr(oj, f)), (k, f)
        Tt, Tj = out.T_W_B.numpy(), oj.T_W_B
        assert float(np.linalg.norm(Tt[:3, 3] - Tj[:3, 3])) <= POSE_TOL, k
        c = (np.trace(Tj[:3, :3].T @ Tt[:3, :3]) - 1.0) / 2.0
        assert float(np.arccos(np.clip(c, -1.0, 1.0))) <= POSE_TOL, k
        alive = tables[k].alive
        np.testing.assert_array_equal(state.table.alive.numpy(), alive)
        for f in ("A0", "A1"):
            np.testing.assert_allclose(
                getattr(state.table, f).numpy()[alive],
                getattr(tables[k], f)[alive], rtol=0, atol=A_TOL,
                err_msg=f"frame {k} {f}")
        saw_ba = saw_ba or bool(out.ba_success)
    assert saw_ba and int(out.n_tracked) >= 10
    assert float(out.T_W_B[0, 3]) > 0.02, "the rig must have moved"
