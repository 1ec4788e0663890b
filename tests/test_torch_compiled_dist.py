"""The compiled distributed steps (rsvio_tpu_torch/parallel/dist_estimator.py:
make_compiled_distributed_estimator_step and
make_compiled_distributed_vio_estimator_step) on the CPU.

Two gloo ranks (ONE spawn through tests/torch_dist_ranks.py, a file store
under tmp_path, 120 s deadline; the ranks import neither JAX nor
rsvio_tpu) run tests/test_torch_dist_estimator.py's tiny config (120x160,
capacity 96, window 4) on tests/test_estimator.py's rendered sequence,
the eager distributed step and then the compiled one (on the CPU its
segments run eagerly over the fixed buffers) for VO, VO with
marginalization and VIO. Held: the compiled step bit for bit the eager
one every frame (pose, keyframe and BA flags, the final velocity), a
sharded solve fired, the two ranks bitwise equal, the same variant keys
every frame on both ranks (every rank must replay the same graphs in the
same order), the mesh's collective counts of the compiled run equal to
the eager run's, and one blocking read a frame.

The chain to JAX is the one the eager distributed step already has
(eager distributed -> single-device step -> JAX). Besides, a world-size-1
mesh made in this process runs the compiled distributed VO step against
the JAX package's jitted single-device step on the same frames (both on
the gather KLT route, as tests/test_dist_estimator.py configures JAX) at
that file's tolerance, 5e-3 m, with equal keyframe flags. JAX's
distributed step on a 2-device mesh is not run (over 40 s on one worker,
tests/test_torch_dist_estimator.py).

And the refusals: a probe, a gloo mesh with a CUDA device (a stand-in mesh
object; nothing touches CUDA) and a capacity that does not divide.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rsvio_tpu.models import estimator as jest
from rsvio_tpu_torch.models import estimator as est
from rsvio_tpu_torch.models import estimator_vio as ev
from rsvio_tpu_torch.ops.klt import KLTConfig
from rsvio_tpu_torch.parallel import dryrun, mesh as mesh_mod
from rsvio_tpu_torch.parallel.dist_estimator import (
    make_compiled_distributed_estimator_step,
    make_compiled_distributed_vio_estimator_step)

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from test_dist_estimator import _cfg as jax_cfg, _rig as jax_rig  # noqa: E402
from test_estimator import sequence  # noqa: E402,F401  (fixture)

torch.set_num_threads(2)

# (name, use_marginalization, vio, frames)
RUNS = [("vo", False, False, 10), ("vo_marg", True, False, 10),
        ("vio", False, True, 10)]
COUNT_KEYS = ("all_gather_bytes", "all_gather_calls", "all_reduce_bytes",
              "all_reduce_calls")     # sorted, as the ranks record them


@pytest.fixture(scope="module")
def ranked(sequence, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("compiled_dist")
    path = str(d / "frames.npz")
    np.savez(path, frames=np.stack([np.stack(f) for f in sequence]))
    return dryrun.run_ranks(ranks.compiled_step_cases, 2, path, RUNS,
                            devices="cpu", timeout=120.0, workdir=str(d),
                            threads=2)


def _run(r, name, kind):
    pre = f"{name}.{kind}."
    return {k[len(pre):]: v for k, v in r.items() if k.startswith(pre)}


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_compiled_distributed_step_matches_eager(ranked, run):
    name, _, _, n = run
    for r in ranked:
        eager, comp = _run(r, name, "eager"), _run(r, name, "compiled")
        for k in ("T_W_B", "is_keyframe", "ba_success", "vel"):
            np.testing.assert_array_equal(comp[k], eager[k], err_msg=k)
        assert comp["ba_success"].any(), "no sharded solve fired"
        counts = dict(zip(COUNT_KEYS, comp["counts"]))
        assert counts["all_reduce_calls"] > 0 and counts["all_gather_calls"] > 0
        np.testing.assert_array_equal(comp["counts"], eager["counts"])
        assert int(comp["host_reads"]) == n
        assert len(comp["variants"]) == n
    for k in ("T_W_B", "variants"):
        np.testing.assert_array_equal(ranked[0][f"{name}.compiled.{k}"],
                                      ranked[1][f"{name}.compiled.{k}"])


@pytest.fixture(scope="module")
def mesh1():
    """A world-size-1 gloo mesh on the CPU in this process, its group
    destroyed after the module's tests."""
    m = mesh_mod.make_mesh(devices="cpu")
    yield m
    dist.destroy_process_group()


def test_world_size_one_compiled_step_matches_jax(sequence, mesh1):  # noqa: F811
    cfg = ranks.step_config(False, False)
    cfg = cfg._replace(frontend=cfg.frontend._replace(
        klt=cfg.frontend.klt._replace(backend="xla")))
    assert cfg.frontend.klt == KLTConfig(levels=3, max_iterations=12,
                                         backend="xla")
    step = make_compiled_distributed_estimator_step(cfg, mesh1)
    rig, state = ranks.step_rig(), est.init_state(cfg, device="cpu")
    jcfg, jrig = jax_cfg(False), jax_rig()
    jstep, jstate = jest.make_estimator_step(jcfg), jest.init_state(jcfg)
    for k, (a, b) in enumerate(sequence):
        state, out = step(state, rig, torch.from_numpy(a),
                          torch.from_numpy(b))
        jstate, jout = jstep(jstate, jrig, jnp.asarray(a), jnp.asarray(b))
        assert bool(out.is_keyframe) == bool(jout.is_keyframe), k
        np.testing.assert_allclose(out.T_W_B[:3, 3].numpy(),
                                   np.asarray(jout.T_W_B)[:3, 3], rtol=0,
                                   atol=5e-3, err_msg=f"frame {k}")
    assert mesh1.counts["all_reduce_calls"] > 0
    assert step.host_reads == len(sequence)


def test_compiled_makers_refuse():
    cfg = ranks.step_config(False, False)
    vcfg = ev.VIOEstimatorConfig(base=cfg)
    makers = (make_compiled_distributed_estimator_step,
              make_compiled_distributed_vio_estimator_step)
    gloo_cuda = mesh_mod.Mesh(None, 0, 1, torch.device("cuda", 0), "gloo")
    assert not gloo_cuda.capturable
    assert mesh_mod.Mesh(None, 0, 1, torch.device("cuda", 0),
                         "nccl").capturable
    cpu2 = mesh_mod.Mesh(None, 0, 2, torch.device("cpu"), "gloo")
    bad = cfg._replace(frontend=cfg.frontend._replace(capacity=97))
    for make, c, b in zip(makers, (cfg, vcfg),
                          (bad, ev.VIOEstimatorConfig(base=bad))):
        with pytest.raises(ValueError, match="gloo.*cannot be captured"):
            make(c, gloo_cuda)
        with pytest.raises(ValueError, match="gloo.*cannot be captured"):
            make(c, cpu2, device="cuda")
        with pytest.raises(ValueError, match="probe"):
            make(c, cpu2, probe={})
        with pytest.raises(ValueError, match="not divisible"):
            make(b, cpu2)
        # On the CPU a gloo mesh is fine: the segments run eagerly.
        assert make(c, cpu2).device == torch.device("cpu")
