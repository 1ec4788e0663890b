"""The port's synthetic scenes (data/synthetic.py, no OpenCV) against the
JAX package's (rsvio_tpu/data/synthetic.py, cv2).

* Trajectories and IMU are host numpy copies: ``Trajectory.pose``,
  ``sample_imu`` (biases and seeded noise), ``tilted`` and
  ``generate_sequence``'s poses and IMU streams exactly equal.
* Textures: torch's bicubic upscale against ``cv2.resize(INTER_CUBIC)``
  within 1e-3 grey levels (measured 6.1e-5 at 1024 px: both use a = -0.75
  and half-pixel centres).
* Frames: the torch ray-cast and bilinear sample against ``cv2.remap
  (INTER_LINEAR, BORDER_REPLICATE)`` within 5e-3 grey levels (measured
  6.0e-4 on the depth-structured scene at 188x120). cv2 quantizes the
  sample position to 1/32 px; on these smooth textures that moves a pixel
  by less than the tolerance, so pixels are close but not equal.
"""

import numpy as np
import pytest
import torch

from rsvio_tpu.data import synthetic as js
from rsvio_tpu_torch.data import synthetic as ts

torch.set_num_threads(2)

H, W = 120, 188
TEX_TOL = 1e-3
RENDER_TOL = 5e-3


@pytest.mark.parametrize("name", ["forward", "6dof", "6dof_tilted"])
def test_trajectory_pose_and_imu_equal(name):
    make = {"forward": lambda m: m.traj_forward(),
            "6dof": lambda m: m.traj_6dof(),
            "6dof_tilted": lambda m: m.tilted(m.traj_6dof(), 7.0, -4.0)}[name]
    tj, tt = make(js), make(ts)
    for t in (0.0, 0.37, 2.9):
        np.testing.assert_array_equal(tt.pose(t), tj.pose(t))
    kw = dict(rate=200.0, gyro_bias=[0.003, -0.002, 0.004],
              accel_bias=[0.02, -0.015, 0.01], gyro_noise=1.7e-4,
              accel_noise=2.0e-3)
    want = tj.sample_imu(-0.05, 0.4, noise_rng=np.random.default_rng(3),
                         **kw)
    got = tt.sample_imu(-0.05, 0.4, noise_rng=np.random.default_rng(3),
                        **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("size,seed", [(256, 0), (1024, 3)])
def test_texture_matches_cv2(size, seed):
    want = js.make_texture(size, seed=seed)
    got = ts.make_texture(size, seed=seed, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= TEX_TOL
    small = ((70.0, 16), (50.0, 64))
    np.testing.assert_allclose(
        ts.make_texture(size, seed=seed, scales=small, device="cpu").numpy(),
        js.make_texture(size, seed=seed, scales=small), atol=TEX_TOL)


def _scene_pair(name):
    mk_t = ts.MATRIX_SCENES[name][0]
    mk_j = js.MATRIX_SCENES[name][0]
    return mk_j(H, W), mk_t(H, W, device="cpu")


@pytest.mark.parametrize("name", ["easy_plane", "depth_6dof",
                                  "photometric_6dof", "occlusion_6dof"])
def test_render_stereo_matches_cv2(name):
    sj, st = _scene_pair(name)
    fields = ("H", "W", "fx", "fy", "cx", "cy", "baseline")
    assert [getattr(st, f) for f in fields] == \
        [getattr(sj, f) for f in fields]
    assert len(st.planes) == len(sj.planes)
    traj = js.MATRIX_SCENES[name][1]()
    for t in (0.0, 1.3, 3.7):
        T = traj.pose(t)
        for a, b in zip(ts.render_stereo(st, T, t),
                        js.render_stereo(sj, T, t)):
            assert a.dtype == torch.float32 and a.shape == (H, W)
            assert float(np.abs(a.numpy() - b).max()) <= RENDER_TOL, (t,)


def test_generate_sequence_matches_jax():
    sj = js.scene_depth_structured(H, W)
    st = ts.scene_depth_structured(H, W, device="cpu")
    kw = dict(gyro_bias=[0.003, -0.002, 0.004])
    want = js.generate_sequence(sj, js.traj_6dof(), 4, imu_rate=200.0,
                                imu_kwargs=kw)
    got = ts.generate_sequence(st, ts.traj_6dof(), 4, imu_rate=200.0,
                               imu_kwargs=kw)
    for k in ("ts", "gt_T_W_B", "imu_ts", "gyro", "accel", "imu_dts"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for (a, b), (c, d) in zip(got["frames"], want["frames"]):
        assert float(np.abs(a.numpy() - c).max()) <= RENDER_TOL
        assert float(np.abs(b.numpy() - d).max()) <= RENDER_TOL
    assert set(ts.MATRIX_SCENES) == set(js.MATRIX_SCENES)
    np.testing.assert_array_equal(ts.R_LEVEL, js.R_LEVEL)
    np.testing.assert_array_equal(ts.GRAVITY_W, js.GRAVITY_W)
