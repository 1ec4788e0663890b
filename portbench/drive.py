"""The system under test, driven as a user drives it: the port's compiled
steps (the ones ``cli/run`` runs on the card) over the benchmark's streams.

Everything that touches ``rsvio_tpu_torch`` is in this module. A stream
holds its frames as the command line hands them to the step (uint8 in
pinned host memory, uploaded and cast in the loop), its IMU buffers (host
arrays, as ``cli/run._imu_buffer_for_frame`` builds them), its compiled
step and state, its own CUDA stream, and after every frame one read of the
pose (with the keyframe flag, the track counts and, for VIO, the velocity)
into pinned host memory.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time

import numpy as np
import torch

from . import scene

def import_program() -> None:
    """Import the compiled steps' modules (timed apart in set-up)."""
    import rsvio_tpu_torch.models.estimator  # noqa: F401
    import rsvio_tpu_torch.models.estimator_vio  # noqa: F401


def load_kernels() -> float:
    """Build or load the KLT library from the checkout's build directory;
    returns the seconds its compile took (0 when a build was found)."""
    from rsvio_tpu_torch.ops.cuda import klt_kernel
    return klt_kernel.load_library().seconds


def write_yaml(cfg: dict, path: str) -> None:
    """The configuration's sections as the YAML file the program loads."""
    lines = ["%YAML:1.0", "---"]
    for key, val in cfg.items():
        if isinstance(val, dict):
            lines.append(f"{key}:")
            for k, v in val.items():
                lines.append(f"  {k}: {_yaml_value(v)}")
        else:
            lines.append(f"{key}: {_yaml_value(val)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _yaml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_value(x) for x in v) + "]"
    if isinstance(v, float):
        # The program's reader takes 1.0e-6 as a number and 1e-06 as text.
        s = repr(v)
        if "e" in s and "." not in s.split("e")[0]:
            m, e = s.split("e")
            s = f"{m}.0e{e}"
        return s
    return repr(v)


class Program:
    """The program's configuration and step maker for one configuration
    file: kind "vo" or "vio"."""

    def __init__(self, conf: dict, device):
        from rsvio_tpu_torch.utils.config import (load_config,
                                                  make_estimator_config)

        self.kind = conf["kind"]
        self.device = torch.device(device)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "config.yaml")
            write_yaml(conf["config"], path)
            self.cfg = load_config(path)
        self.ecfg, self.rig = make_estimator_config(
            self.cfg, kind=self.kind, device=self.device)
        if self.kind == "vio":
            from rsvio_tpu_torch.cli.run import vio_config
            self.vcfg = vio_config(self.cfg, self.ecfg)
        self.window = self.ecfg.window_size

    def make_step(self):
        if self.kind == "vio":
            from rsvio_tpu_torch.models.estimator_vio import \
                make_compiled_vio_estimator_step
            return make_compiled_vio_estimator_step(self.vcfg,
                                                    device=self.device)
        from rsvio_tpu_torch.models.estimator import \
            make_compiled_estimator_step
        return make_compiled_estimator_step(self.ecfg, device=self.device)

    def initial_state(self, imu: scene.Imu | None):
        """A VO state at identity; a VIO state from the command line's
        bootstrap over the static head's samples."""
        if self.kind == "vio":
            from rsvio_tpu_torch.cli.run import vio_bootstrap
            ns = (np.arange(len(imu.head_gyro)) * 1e9 / imu.rate).astype(
                np.int64)
            return vio_bootstrap(self.vcfg, {"ts": ns,
                                             "gyro": imu.head_gyro,
                                             "accel": imu.head_accel},
                                 torch.float32, self.device)
        from rsvio_tpu_torch.models.estimator import init_state
        return init_state(self.ecfg, device=self.device)


def capture_count(step) -> int:
    """Variants captured so far (on the CPU: variants run)."""
    g = step.graphs
    return len(g.graphs) if g.device.type == "cuda" else len(g.uses)


class Stream:
    """One sequence in flight: frame k of the stream is loop frame
    (start + k) mod F."""

    def __init__(self, index: int, start: int, frames, imu_buffers, program,
                 snap_p: float, snap_rng: np.random.Generator):
        self.index, self.start = index, start
        self.frames = frames               # (left, right) uint8 (F, H, W)
        self.imu = imu_buffers             # None or (gyro, accel, dts, mask)
        self.program = program
        self.dev = program.device
        self.cuda = self.dev.type == "cuda"
        self.stream = torch.cuda.Stream(self.dev) if self.cuda else None
        self.step = program.make_step()
        self.state = None
        self.k = 0
        self.snap_p, self.snap_rng = snap_p, snap_rng
        self.records = []      # per frame: (k, j, t0, t1, is_kf)
        self.poses = []        # (16,) float32 per frame
        self.vel = []          # (3,) per frame, VIO
        self.counts = []       # (n_alive, n_tracked) per frame
        self.snaps = []        # sampled frames' state copies
        self.sampling = False
        pin = self.cuda
        self._host = {
            "T_W_B": torch.zeros(16, dtype=torch.float32, pin_memory=pin),
            "is_keyframe": torch.zeros(1, dtype=torch.bool, pin_memory=pin),
            "n_alive": torch.zeros(1, dtype=torch.int32, pin_memory=pin),
            "n_tracked": torch.zeros(1, dtype=torch.int32, pin_memory=pin),
            "vel": torch.zeros(3, dtype=torch.float32, pin_memory=pin)}
        self._event = torch.cuda.Event() if self.cuda else None

    def _upload(self, t):
        if self.cuda:
            return t.to(self.dev, non_blocking=True).to(torch.float32)
        return t.to(torch.float32)

    def _inputs(self, j: int):
        """Loop frame j's arguments after the state and rig: the two images
        on the device and, for VIO, the frame's IMU buffer (the stream's
        first frame has no samples, as on the command line)."""
        imgs = (self._upload(self.frames[0][j]),
                self._upload(self.frames[1][j]))
        if self.imu is None:
            return imgs
        g, a, d, m = self.imu
        if self.k == 0:
            return imgs + (np.zeros_like(g[j]), np.zeros_like(a[j]),
                           np.zeros_like(d[j]), np.zeros_like(m[j]))
        return imgs + (g[j], a[j], d[j], m[j])

    def frame(self, clock=time.perf_counter):
        """Run the next frame through the step and read its pose; returns
        (t_start, t_done, is_kf) on `clock`."""
        j = (self.start + self.k) % len(self.frames[0])
        t0 = clock()
        args = self._inputs(j)
        prev = self.state
        state, out = self.step(prev, self.program.rig, *args)
        h = self._host
        srcs = {"T_W_B": out.T_W_B, "is_keyframe": out.is_keyframe,
                "n_alive": out.n_alive, "n_tracked": out.n_tracked}
        if self.imu is not None:
            srcs["vel"] = state.vel
        for name, src in srcs.items():
            h[name].copy_(src.reshape(-1), non_blocking=self.cuda)
        if self.cuda:
            self._event.record()
            self._event.synchronize()
        t1 = clock()
        is_kf = bool(h["is_keyframe"][0])
        self.records.append((self.k, j, t0, t1, is_kf))
        self.poses.append(h["T_W_B"].numpy().copy())
        self.counts.append((int(h["n_alive"][0]), int(h["n_tracked"][0])))
        if self.imu is not None:
            self.vel.append(h["vel"].numpy().copy())
        if self.sampling and prev is not None \
                and self.snap_rng.random() < self.snap_p:
            self.snaps.append(snapshot(self.k, prev, state))
        self.state = state
        self.k += 1
        return t0, t1, is_kf

    def frames_with_stream(self, n: int = 1):
        """Run n frames on this stream's CUDA stream."""
        if self.cuda:
            with torch.cuda.stream(self.stream):
                for _ in range(n):
                    self.frame()
        else:
            for _ in range(n):
                self.frame()


def snapshot(k: int, prev, state) -> dict:
    """Device copies of what the reference judges at frame k: the feature
    table before and after the step, the window and the map after it, and
    for VIO the window's velocities, biases and preintegrations."""
    def c(t):
        return t.detach().clone()

    snap = {"k": k,
            "prev": {f: c(getattr(prev.table, f)) for f in
                     ("pos0", "pos1", "fid", "alive")},
            "table": {f: c(getattr(state.table, f)) for f in
                      ("pos0", "pos1", "fid", "alive")},
            "kf_T_W_B": c(state.kf_T_W_B), "kf_count": c(state.kf_count),
            "lm": c(state.lm), "lm_fid": c(state.lm_fid),
            "T_W_B": c(state.T_W_B)}
    if hasattr(state, "kf_preint"):
        p = state.kf_preint
        snap["preint"] = {f: c(getattr(p, f)) for f in
                          ("dR", "dv", "dp", "dt", "bias_gyro",
                           "bias_accel")}
        snap["preint_valid"] = c(state.kf_preint_valid)
        for f in ("kf_vel", "kf_bg", "kf_ba", "vel", "bg", "ba"):
            snap[f] = c(getattr(state, f))
    return snap


def snapshot_to_host(snap: dict) -> dict:
    out = {}
    for k, v in snap.items():
        if isinstance(v, dict):
            out[k] = snapshot_to_host(v)
        elif torch.is_tensor(v):
            out[k] = v.cpu().numpy()
        else:
            out[k] = v
    return out


def warm(stream: Stream, need, max_frames: int) -> dict:
    """Run `stream` until `need(stream)` holds (every variant of its frames
    is captured) or `max_frames` frames; for VIO, then capture the keyframe
    stage for every interval length (warm_intervals) and run one more frame.
    Returns the frames run, the seconds spent and the variants captured."""
    t0 = time.perf_counter()
    n = 0
    while n < max_frames and not need(stream):
        stream.frames_with_stream(1)
        n += 1
    if stream.imu is not None:
        warm_intervals(stream)
        stream.frames_with_stream(1)
        n += 1
    if stream.cuda:
        torch.cuda.synchronize(stream.dev)
    return {"frames": n, "s": time.perf_counter() - t0,
            "captures": capture_count(stream.step)}


def warm_intervals(stream: Stream) -> int:
    """Capture the VIO step's keyframe-stage variant for every length of
    the interval since the last keyframe, from one step's sample count to
    the interval buffer's, in powers of two (the step keys its
    preintegration loop by the length rounded up to one). Which lengths a
    stream meets follows its estimated motion, so none is left to be
    captured inside the window. Each probe runs the stream's next frame on
    a copy of its state with one slot left in the window (the step then
    takes a keyframe) and the interval's sample count set; the results are
    dropped, and the stream goes on from a copy of its own state, which the
    step loads as a state it did not return. Returns the probes run."""
    from torch.utils._pytree import tree_map

    keep = tree_map(lambda t: t.clone() if torch.is_tensor(t) else t,
                    stream.state)
    j = (stream.start + stream.k) % len(stream.frames[0])
    args = stream._inputs(j)
    n_valid = int(np.count_nonzero(args[-1]))
    cap = stream.program.vcfg.interval_buf
    kf = torch.full_like(keep.kf_count, stream.program.window - 1)
    n, probes = 16, 0
    ctx = (torch.cuda.stream(stream.stream) if stream.cuda
           else contextlib.nullcontext())
    with ctx:
        while n <= cap:
            if n >= n_valid:
                scratch = keep._replace(
                    kf_count=kf,
                    buf_count=torch.full_like(keep.buf_count, n - n_valid))
                stream.step(scratch, stream.program.rig, *args)
                probes += 1
            n *= 2
    stream.state = keep
    return probes


def run_closed(streams, seconds: float, threads: bool, slicer=None,
               slice_s: float = 0.0, lead_s: float = 0.5):
    """Every stream as fast as it goes for `seconds`: one host thread per
    stream on its own CUDA stream (or, with threads=False, the streams in
    turn from this thread). Returns (t0, t_end). A slicer (trace.Slice) is
    armed for slice_s + lead_s before the end (its start takes a few tens
    of ms once initialized) and stopped once every stream has stopped."""
    barrier = threading.Barrier(len(streams) + 1 if threads else 1)
    box = {}
    errors = []

    def body(s):
        try:
            barrier.wait()
            t_end = box["t_end"]
            if s.cuda:
                with torch.cuda.stream(s.stream):
                    while time.perf_counter() < t_end:
                        s.frame()
            else:
                while time.perf_counter() < t_end:
                    s.frame()
        except BaseException as e:      # re-raised below
            errors.append(e)

    ts = [threading.Thread(target=body, args=(s,), daemon=True)
          for s in streams] if threads else []
    for t in ts:
        t.start()
    box["t0"] = time.perf_counter()
    box["t_end"] = box["t0"] + seconds
    if slicer is not None:
        slicer.arm(box["t_end"] - slice_s - lead_s)
    if threads:
        barrier.wait()
        for t in ts:
            t.join()
    else:
        while time.perf_counter() < box["t_end"]:
            for s in streams:
                if time.perf_counter() >= box["t_end"]:
                    break
                s.frames_with_stream(1)
    if slicer is not None:
        slicer.stop()
    if errors:
        raise errors[0]
    return box["t0"], box["t_end"]


def run_open(stream: Stream, seconds: float, rate_hz: float, slicer=None,
             slice_s: float = 0.0, lead_s: float = 0.5):
    """Frames due at t0 + k / rate_hz for the frames due in the window; a
    late frame starts as soon as the one before it is done and is never
    skipped. Frames due in the window but not done by its end are run
    after it (late, not wrong). Returns (t0, t_end, due times)."""
    n_due = int(np.ceil(seconds * rate_hz - 1e-9))
    t0 = time.perf_counter() + 0.01
    t_end = t0 + seconds
    due = t0 + np.arange(n_due) / rate_hz
    if slicer is not None:
        slicer.arm(t_end - slice_s - lead_s)
    errors = []

    def body():
        try:
            ctx = torch.cuda.stream(stream.stream) if stream.cuda else None
            if ctx is not None:
                ctx.__enter__()
            for k in range(n_due):
                wait = due[k] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                stream.frame()
            if ctx is not None:
                ctx.__exit__(None, None, None)
        except BaseException as e:      # re-raised below
            errors.append(e)

    # The stream's frames run on a thread of their own, as in run_closed.
    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join()
    if slicer is not None:
        slicer.stop()
    if errors:
        raise errors[0]
    return t0, t_end, due
