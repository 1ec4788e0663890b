"""The port's distributed steps (rsvio_tpu_torch/parallel/dist_estimator.py),
its multihost helpers and dryrun_multichip, at world size 2 over gloo on
the CPU.

The steps: tests/test_dist_estimator.py's tiny config (120x160, capacity
96, window 4) on tests/test_estimator.py's rendered sequence, run by two
spawned ranks (ONE spawn for the steps and helpers, a file store under
tmp_path, 120 s deadline; the ranks import neither JAX nor rsvio_tpu) and
held to the port's single-device step over the same frames, which
tests/test_torch_estimator.py holds to JAX. (JAX's distributed step on a
2-device mesh recompiles its sharded solve at every keyframe: well over
40 s on one worker for these frames, so it is not run here.) Tolerances:
those of test_dist_estimator.py, the x position within 5e-3 m (VO) and
1e-2 (VIO, x and the final velocity); here the whole pose is held, the
keyframe flags are equal, a sharded solve fires, and the two ranks' poses
are bitwise equal.

dryrun_multichip(2, backend="gloo") runs on the CPU in a second spawn.
"""

import os
import sys

import numpy as np
import pytest
import torch

from rsvio_tpu_torch.models import estimator as est
from rsvio_tpu_torch.models import estimator_vio as ev
from rsvio_tpu_torch.parallel import dryrun, mesh as mesh_mod, multihost
from rsvio_tpu_torch.parallel.dist_estimator import (
    make_distributed_estimator_step, make_distributed_vio_estimator_step)

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from test_estimator import sequence  # noqa: E402,F401  (fixture)

torch.set_num_threads(2)

# (name, use_marginalization, vio, frames)
RUNS = [("vo", False, False, 14), ("vo_marg", True, False, 14),
        ("vio", False, True, 10), ("vio_marg", True, True, 10)]
TOL = {False: 5e-3, True: 1e-2}


@pytest.fixture(scope="module")
def ranked(sequence, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("dist_steps")
    path = str(d / "frames.npz")
    np.savez(path, frames=np.stack([np.stack(f) for f in sequence]))
    return dryrun.run_ranks(ranks.step_cases, 2, path, RUNS, devices="cpu",
                            timeout=120.0, workdir=str(d), threads=2)


@pytest.fixture(scope="module")
def single(sequence):  # noqa: F811
    frames = np.stack([np.stack(f) for f in sequence])
    out = {}
    for name, use_marg, vio, n in RUNS:
        cfg = ranks.step_config(use_marg, vio)
        step = (ev.make_vio_estimator_step(cfg) if vio
                else est.make_estimator_step(cfg))
        out[name] = ranks.run_steps(step, vio, cfg, frames[:n])
    return out


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_distributed_step_matches_single_device(ranked, single, run):
    name, _, vio, _ = run
    want = single[name]
    for r in ranked:
        got = {k[len(name) + 1:]: v for k, v in r.items()
               if k.startswith(name + ".")}
        np.testing.assert_array_equal(got["is_keyframe"],
                                      want["is_keyframe"])
        assert got["ba_success"].any(), "no sharded solve fired"
        np.testing.assert_allclose(got["T_W_B"], want["T_W_B"], rtol=0,
                                   atol=TOL[vio])
        np.testing.assert_allclose(got["vel"], want["vel"], rtol=0,
                                   atol=TOL[vio])
    np.testing.assert_array_equal(ranked[0][f"{name}.T_W_B"],
                                  ranked[1][f"{name}.T_W_B"])
    # It tracks the motion (0.02 m a frame along x).
    x = want["T_W_B"][:, 0, 3]
    assert x[-1] > 0.5 * 0.02 * (len(x) - 1)


def test_capacity_must_divide_mesh():
    mesh2 = mesh_mod.Mesh(None, 0, 2, torch.device("cpu"), "gloo")
    cfg = ranks.step_config(False, False)
    bad = cfg._replace(frontend=cfg.frontend._replace(capacity=97))
    with pytest.raises(ValueError, match="not divisible"):
        make_distributed_estimator_step(bad, mesh2)
    with pytest.raises(ValueError, match="not divisible"):
        make_distributed_vio_estimator_step(
            ev.VIOEstimatorConfig(base=bad), mesh2)


def test_multihost_helpers_on_two_ranks(ranked):
    assert [tuple(r["host_local_slice"]) for r in ranked] == [(0, 4), (4, 8)]
    full = np.arange(12.0).reshape(2, 6)
    np.testing.assert_array_equal(ranked[0]["shard"], full[:, :3])
    np.testing.assert_array_equal(ranked[1]["shard"], full[:, 3:])
    for r in ranked:
        # (0.5 + 1.5) twice and 3 + 4, each back in its own dtype.
        np.testing.assert_array_equal(r["packed"], [2.0, 2.0, 7.0])
        assert list(r["packed_dtypes"]) == ["torch.float32", "torch.int64"]


def test_initialize_distributed_is_a_noop_at_one_process():
    multihost.initialize_distributed(num_processes=1)
    multihost.initialize_distributed(None, None, None)
    assert not torch.distributed.is_initialized()
    assert multihost.host_local_slice(10) == (0, 10)


def test_nccl_with_more_ranks_than_cards_raises():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{n + 1} ranks.*{n} cards"):
        mesh_mod.check_nccl_ranks("nccl", n + 1)
    with pytest.raises(ValueError, match="one rank per card"):
        multihost.initialize_distributed("tcp://localhost:1", n + 2, 0,
                                         backend="nccl")
    assert not torch.distributed.is_initialized()
    mesh_mod.check_nccl_ranks("gloo", n + 8)


def test_dryrun_multichip_gloo_on_cpu(capfd):
    dryrun.dryrun_multichip(2, backend="gloo", devices="cpu", threads=1)
    out = capfd.readouterr().out
    for what in ("distributed BA ok", "distributed marginalized BA ok",
                 "distributed VIO BA ok",
                 "distributed marginalized VIO BA ok",
                 "full distributed estimator step ok",
                 "full distributed VIO estimator step ok"):
        assert f"dryrun_multichip(2): {what}" in out, (what, out)
