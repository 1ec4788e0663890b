"""The port's VIO step with its option sets against the JAX package's, on
tests/test_torch_vio.py's tiny scene, IMU buffer and tolerances:

  * "gate": the RANSAC consensus gate (8 hypotheses, JAX's Gumbel draws
    injected) with the health-gated desert bias stiffness (gyro 1e5, accel
    1e6) and vision_weight_adaptive on score-weighted observations. Health
    is ramped between 0.9 and 1.1 (as tests/test_torch_options.py's
    adaptive set), so on this clean scene every closing interval carries a
    desert factor of ~0.5 and the weights are scaled.
  * "empty_imu": a buffer with no valid sample on any frame (the step
    degrades to VO with the IMU prediction switched off by its device
    select; every interval invalid).
"""

import numpy as np
import pytest

from test_torch_vio import (assert_sequence_matches, imu_buffer, jax_draws,
                            run_jax, torch_step, vio_cfgs)
from test_torch_estimator import _frames

K_HYP = 8
GATE = dict(use_obs_weights=True, vision_weight_adaptive=True,
            health_f_lo=0.9, health_f_hi=1.1,
            pnp=dict(ransac_hypotheses=K_HYP),
            vio=dict(bias_gyro_weight_desert=1e5,
                     bias_accel_weight_desert=1e6))


@pytest.fixture(scope="module")
def jax_gate():
    import copy
    return run_jax(vio_cfgs(**copy.deepcopy(GATE))[0], imu_buffer())


@pytest.fixture(scope="module")
def jax_empty():
    return run_jax(vio_cfgs()[0], imu_buffer(n=0))


def test_gate_desert_adaptive_sequence_matches_jax(jax_gate):
    import copy
    cfg_t = vio_cfgs(**copy.deepcopy(GATE))[1]
    step = torch_step(cfg_t, draws=jax_draws(len(_frames()), K_HYP))
    state = assert_sequence_matches(cfg_t, jax_gate, imu_buffer(), step=step)
    sj = jax_gate["states"][-1]
    assert state.kf_bias_alpha is not None and state.lm_birth is not None
    np.testing.assert_allclose(state.kf_bias_alpha.numpy(), sj.kf_bias_alpha,
                               atol=1e-4)
    np.testing.assert_allclose(float(state.health_ema), float(sj.health_ema),
                               atol=1e-4)
    # The options took effect: desert factors and scaled weights.
    assert float(state.kf_bias_alpha.max()) > 0.1
    assert float(state.obs_w.min()) < 1.0
    outs = jax_gate["outs"]
    assert max(int(o.n_ransac_inliers) for o in outs) >= 8


def test_empty_imu_buffer_sequence_matches_jax(jax_empty):
    cfg_t = vio_cfgs()[1]
    state = assert_sequence_matches(cfg_t, jax_empty, imu_buffer(n=0))
    assert int(state.buf_count) == 0
    assert not bool(state.kf_preint_valid.any())
