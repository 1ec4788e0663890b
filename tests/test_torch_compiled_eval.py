"""The evaluation harness on the compiled path, on the CPU.

utils.evaluation.run_synthetic_sequence drives the compiled step
(make_compiled_estimator_step / make_compiled_vio_estimator_step) when no
probe is given, and the eager step with a probe (a replay cannot update a
Python dict). On the CPU the compiled step runs the same segments eagerly
over its fixed buffers, so the two calls must agree bit for bit: here
vo_fifo and vio_fifo at tests/test_torch_evaluation.py's small geometry
(120x188, capacity 96, window 5, 3 levels, kernel route), 14 frames at
10 Hz of the port's own renders of that file's scenes (depth_6dof; the
plane at 2.5 m for VIO) with the accuracy matrix's IMU biases and noise.
Every per-frame statistic and the scores are held equal, and each call
is held to the step maker it must take. tests/test_torch_evaluation.py
holds the harness (now the compiled path) to JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rsvio_tpu_torch.data import synthetic as syn
from rsvio_tpu_torch.models import estimator as est
from rsvio_tpu_torch.models import estimator_vio as ev
from rsvio_tpu_torch.utils import evaluation

torch.set_num_threads(2)

H, W, N_FRAMES = 120, 188, 14
SMALL = dict(capacity=96, window=5, levels=3, cell_size=24,
             detect_margin=10, translation_threshold=0.03,
             rotation_threshold=0.03, backend="pallas")
IMU_KW = dict(gyro_bias=[0.003, -0.002, 0.004],
              accel_bias=[0.02, -0.015, 0.01], gyro_noise=1.7e-4,
              accel_noise=2.0e-3)


def _sequence(vio):
    if vio:
        scene = dataclasses.replace(
            syn.scene_easy_plane(H=H, W=W, device="cpu"),
            planes=[syn._frontal_plane(2.5, 7.0, 5.0, 0, device="cpu")])
        traj = syn.traj_6dof(lin_amp=(0.5, 0.2, 0.15),
                             ang_amp_deg=(4.0, 3.0, 2.0))
    else:
        scene = syn.scene_depth_structured(H=H, W=W, device="cpu")
        traj = syn.traj_6dof()
    rng = np.random.default_rng(11)
    seq = syn.generate_sequence(scene, traj, N_FRAMES, fps=10.0,
                                imu_rate=200.0,
                                imu_kwargs=dict(noise_rng=rng, **IMU_KW))
    boot = {}
    if vio:
        boot = dict(zip(("init_gyro", "init_accel"),
                        evaluation.static_init_imu(traj, rng=rng, **IMU_KW)))
    return scene, seq, boot


@pytest.mark.parametrize("vio", [False, True], ids=["vo_fifo", "vio_fifo"])
def test_compiled_harness_matches_eager(vio, monkeypatch):
    scene, seq, boot = _sequence(vio)
    mod = ev if vio else est
    makers = ["make_compiled_vio_estimator_step", "make_vio_estimator_step"] \
        if vio else ["make_compiled_estimator_step", "make_estimator_step"]
    made = []
    for name in makers:
        make = getattr(mod, name)

        def spy(*a, make=make, name=name, **kw):
            made.append(name)
            return make(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    kw = dict(SMALL, use_vio=vio, device="cpu", **boot)
    comp = evaluation.run_synthetic_sequence(seq, scene, **kw)
    assert made[0] == makers[0]
    made.clear()
    probe = {}
    eager = evaluation.run_synthetic_sequence(seq, scene, probe=probe, **kw)
    assert made == [makers[1]]      # the probe keeps the eager step
    np.testing.assert_array_equal(comp.positions, eager.positions)
    assert comp.stats.keys() == eager.stats.keys()
    for k, v in eager.stats.items():
        np.testing.assert_array_equal(comp.stats[k], v, err_msg=k)
    for f in ("ate_rmse", "drift_pct", "n_tracked_mean", "ba_success_rate",
              "skip"):
        assert getattr(comp, f) == getattr(eager, f), f
    assert comp.stats["is_keyframe"].sum() >= SMALL["window"]
    assert comp.ba_success_rate > 0
