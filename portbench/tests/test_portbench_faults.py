"""A whole run of a cell with the timed path broken underneath, on the CPU
(the harness's look for a card skipped, the compiled steps running their
segments eagerly, at half the EuRoC widths and on a 4 s loop so that it
fits a test run): `correct` must come out false for each fault a cell can
have, and true with none. One card, one process: there is no exchange
between chips to leave out.

The control (the program's float32 products in TF32) runs only on the card:
test_control_fails_on_the_card, marked gpu.
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import drive, run, scene, spec


def small_conf(name):
    c = copy.deepcopy(spec.config(name))
    cam = c["config"]["camera"]
    cam["image_width"] //= 2
    cam["image_height"] //= 2
    for k in ("left_intrinsics", "right_intrinsics"):
        cam[k] = [v / 2 for v in cam[k]]
    c["config"]["tracker"]["pyramid_levels"] = 4
    return c


def small_traffic(name, streams):
    t = dict(spec.traffic(name))
    t.update(loop_frames=80, lin_period_s=[4.0, 2.0, 4.0],
             ang_period_s=[4.0, 4.0, 2.0], streams=streams,
             snapshot_share=0.3, span_frames=3)
    return t


class Broken:
    """A stream's step with a fault planted where its answer is made."""

    def __init__(self, step, fault, stream):
        self.step, self.fault, self.stream = step, fault, stream
        self.k = 0
        self.first = None

    @property
    def graphs(self):
        return self.step.graphs

    def __call__(self, state, rig, *args):
        k, self.k = self.k, self.k + 1
        if self.fault == "half" and self.stream % 2 == 1:
            # this half of the batch is left out: its frames come back
            # without the step having run
            if self.first is None:
                self.first = self.step(state, rig, *args)
            return self.first
        new, out = self.step(state, rig, *args)
        if self.fault == "unchanged":
            return state, out._replace(T_W_B=state.T_W_B)
        if self.fault == "altered" and k % 2:
            T = out.T_W_B.clone()
            T[0, 3] += 0.03
            return new, out._replace(T_W_B=T)
        return new, out


def run_small(cell, fault=None, streams=2, seconds=6.0, bench=None,
              limits=None):
    torch.set_num_threads(4)
    bench = bench or spec.load_benchmark()
    w = spec.cell(bench, cell)

    def plant(stream):
        if fault is not None:
            stream.step = Broken(stream.step, fault, stream.index)

    return run.run_cell(cell, 2 ** 31 + 12345, seconds, False, device="cpu",
                        bench=bench, conf=small_conf(w["config"]),
                        traffic=small_traffic(w["traffic"], streams),
                        limits=limits or spec.limits(cell), fault=plant)


CELLS = ("euroc_vo.batch", "euroc_vio.batch")
CASES = [(c, f, f is None) for c in CELLS
         for f in (None, "unchanged", "half", "altered")]


@pytest.mark.parametrize("cell,fault,expect", CASES)
def test_a_fault_makes_the_run_not_correct(cell, fault, expect):
    res = run_small(cell, fault)
    assert res["correct"] is expect, res["checks"]
    assert res["attempted"] > 0


def test_the_open_loop_mode_runs_a_live_stream():
    """The open-loop mode (traffic/live.json: one stream, a frame due every
    50 ms) that a later live cell will use: every due frame is attempted
    and judged. No limits: a live cell has none measured yet."""
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": "euroc_vio.live", "config":
                               "euroc_vio", "traffic": "live", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "latency_p95_ms", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["euroc_vio.live"]})
    res = run_small("euroc_vio.live", None, streams=1, seconds=4.0,
                    bench=bench, limits={"limits": {}})
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"latency_p95_ms", "setup_s"}
    assert res["attempted"] == 80


def test_warm_up_meets_every_interval_and_leaves_the_stream_as_it_was():
    """A VIO stream's warm-up runs the keyframe stage for every interval
    length up to the buffer's, and the stream's poses afterwards are those
    of a stream that ran the same frames without it."""
    torch.set_num_threads(4)
    conf = small_conf("euroc_vio")
    traffic = small_traffic("batch", 1)
    dev = torch.device("cpu")
    program = drive.Program(conf, dev)
    rig = scene.rig_from_config(conf["config"])
    loop = scene.loop_from_traffic(traffic)
    plane = scene.make_plane(loop, rig, float(traffic["plane_dist_m"]))
    frames = scene.render_loop(scene.Renderer(rig, plane, dev), loop,
                               scene.make_texture(7, dev), False)
    imu_cfg = conf["imu"]
    imu = scene.make_imu(loop, rig, imu_cfg, np.random.default_rng(7), 0.0,
                         float(imu_cfg["static_head_s"]))
    buffers = scene.frame_imu_buffers(imu, loop, int(imu_cfg["buffer"]))

    def stream():
        s = drive.Stream(0, 0, frames, buffers, program, 0.0,
                         np.random.default_rng(0))
        s.state = program.initial_state(imu)
        return s

    warmed, plain = stream(), stream()
    w = drive.warm(warmed, lambda st: st.k >= 12, 40)
    plain.frames_with_stream(w["frames"])
    cap = program.vcfg.interval_buf
    lengths = {k[1] for k in warmed.step.graphs.uses if k[0] == "kf_pre"}
    assert {2 ** e for e in range(4, 10) if 2 ** e <= cap} <= lengths
    warmed.frames_with_stream(6)
    plain.frames_with_stream(6)
    assert warmed.k == plain.k
    assert np.array_equal(np.stack(warmed.poses), np.stack(plain.poses))
    assert np.array_equal(np.stack(warmed.vel), np.stack(plain.vel))


@pytest.mark.gpu
def test_control_fails_on_the_card():
    """The control at the cells' own size: the program's float32 products
    in TF32 must make `correct` false (the benchmark's own runs never
    take --control)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "euroc_vio.batch", "--seed", "5000000001", "--seconds", "10",
         "--trace", "0", "--control", "tf32"], cwd=spec.ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ))
    assert r.returncode == 0, r.stderr[-4000:]
    assert '"correct": false' in r.stdout.strip().splitlines()[-1]
