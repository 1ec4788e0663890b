"""The program's own spans (rsvio_tpu_torch.profiling.records()), grouped
by step and frame, and the arithmetic of per-layer readings taken from them.

No metric reads these yet. The tracer records while a torch.profiler session
records, so a traced run's slice holds them, but there the profiler's CUDA
activity tracing makes every ``cudaGraphLaunch`` block for about as long as
its segment runs, and the readings describe the profiler. They are meant for
spans recorded over a window with ``profiling.recording()`` and no profiler.

The records, as the compiled steps make them: ``step`` spans (one a frame,
with the step's ``step`` tag, its ``frame``, ``ready``, ``is_kf`` and
``solve``), and inside them ``step.load``, ``graph.replay`` (host time in
``CUDAGraph.replay()``, with the variant's ``key``), ``step.read`` (the wait
for is_kf) and ``step.emit``; device records ``graph.device`` (from an event
on the step's stream just before a replay to one just after it: the
replay's device time, with its launch when the stream was idle) and
``stream.gap`` (the previous replay's end event to this one's start event),
each with its frame's ``step`` and ``frame`` and its segment's ``layer``:
``motion`` (M / F) or ``keyframe`` (P and K). A frame counts only when its
``step`` span was recorded whole, and in the device readings only when every
replay's device record was read. Each reader returns None when it finds
nothing to read."""

from __future__ import annotations

import numpy as np

from .trace import _union


def records_of(run):
    """The program's records (a profiling.Records), read once a run and
    kept on it; None when the program has no tracer."""
    if not hasattr(run, "program_records"):
        run.program_records = None
        try:
            from rsvio_tpu_torch import profiling
        except ImportError:
            return None
        records = getattr(profiling, "records", None)
        if callable(records):
            run.program_records = records()
    return run.program_records


class Frames:
    """Host spans and device records by (step, frame), for the frames whose
    ``step`` span exists."""

    def __init__(self, records):
        self.step = {}
        for s in records.spans:
            if s.name == "step" and "frame" in s.attrs:
                self.step[(s.attrs["step"], s.attrs["frame"])] = s
        self.of = {k: [] for k in self.step}
        for s in list(records.spans) + list(records.device):
            k = (s.attrs.get("step"), s.attrs.get("frame"))
            if s.name != "step" and k in self.of:
                self.of[k].append(s)

    def named(self, key, name, layer=None):
        return [s for s in self.of[key] if s.name == name
                and (layer is None or s.attrs.get("layer") == layer)]

    def whole(self, key) -> bool:
        """Whether every segment of the frame was replayed (none captured)
        and every replay's ``graph.device`` was read."""
        n = {}
        for s in self.of[key]:
            n[s.name] = n.get(s.name, 0) + 1
        return ("graph.capture" not in n and n.get("graph.replay", 0) > 0
                and n.get("graph.device", 0) == n["graph.replay"])


def ms(s) -> float:
    """A host span's or a device record's length in ms."""
    ns = s.ns if hasattr(s, "ns") else s.end_ns - s.start_ns
    return ns * 1e-6


def _median(xs):
    return float(np.median(xs)) if xs else None


def frames_of(run):
    records = records_of(run)
    if records is None or not records.spans:
        return None
    if not hasattr(run, "program_frames"):
        run.program_frames = Frames(records)
    return run.program_frames if run.program_frames.step else None


def launch_ms(fr: Frames):
    """Median over frames of the frame's summed ``graph.replay`` spans."""
    return _median([sum(ms(s) for s in fr.named(k, "graph.replay"))
                    for k in fr.step if fr.named(k, "graph.replay")])


def launch_busy_pct(spans):
    """The union of every thread's ``graph.replay`` spans over the recorded
    wall time (the first host span's start to the last one's end)."""
    replay = [(s.start_ns, s.end_ns) for s in spans
              if s.name == "graph.replay"]
    if not replay:
        return None
    wall = (max(s.end_ns for s in spans) - min(s.start_ns for s in spans))
    return 100.0 * _union(replay)[0] / wall if wall > 0 else None


def kf_read_wait_ms(fr: Frames):
    """Median ``step.read`` span."""
    return _median([ms(s) for k in fr.step for s in fr.named(k, "step.read")])


def motion_device_ms(fr: Frames):
    """Median ``graph.device`` of segment M / F in the frames that run PnP."""
    return _median([ms(s) for k, st in fr.step.items()
                    if st.attrs.get("ready")
                    for s in fr.named(k, "graph.device", "motion")])


def solve_device_ms(fr: Frames):
    """Median over the frames with the window solve, all of whose replays
    were read, of their summed ``graph.device`` of the keyframe stage (VIO:
    P and K)."""
    return _median([sum(ms(s) for s in fr.named(k, "graph.device",
                                                "keyframe"))
                    for k, st in fr.step.items()
                    if st.attrs.get("solve") and fr.whole(k)])


def stream_gap_ms(fr: Frames):
    """Median over frames of the frame's summed ``stream.gap`` (the wait
    before each of its replays), over the frames whose replays and gaps were
    all read."""
    return _median([sum(ms(s) for s in fr.named(k, "stream.gap"))
                    for k in fr.step if fr.whole(k)
                    and len(fr.named(k, "stream.gap"))
                    == len(fr.named(k, "graph.device"))])
