"""The port's tracer (rsvio_tpu_torch.profiling) on the CPU: off, a span is
one shared null context and nothing is kept; on, spans nest with their
parents and attributes, each thread keeps its own in a bounded buffer that
outlives it, and the stamps share torch.profiler's clock (within 50 us of
its own annotations). utils.graphs.Graphs and the compiled VO step record
``step``, ``step.load``, ``graph.replay``, ``step.read`` and ``step.emit``
once a frame with the frame's keys; the step's device records
(profiling.DeviceSpans) are checked against stand-in timing events, whose
reads are counted: none while the tracer is off.

The step runs on 96x128 frames (tests/test_torch_gpu.py's small scene) for
a few frames; the file takes a few seconds on one worker. The card's side
(captured events, the same poses on and off, no host sync) is
tests/test_torch_gpu.py::test_compiled_step_traced_on_cuda."""

import threading
import time

import pytest
import torch

from rsvio_tpu_torch import profiling
from rsvio_tpu_torch.data import bench_scene
from rsvio_tpu_torch.models import estimator as est
from rsvio_tpu_torch.models.frontend import FrontendConfig
from rsvio_tpu_torch.ops.klt import KLTConfig
from rsvio_tpu_torch.utils.graphs import Graphs

SHAPE = (96, 128)
FRAMES = 4


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(2)
    tex = bench_scene.make_texture(1, size=768,
                                   octaves=((90.0, 24), (60.0, 96)))
    frames = bench_scene.stereo_frames(tex, FRAMES, step_m=0.02, shape=SHAPE,
                                       fx=100.0, plane_z=4.0, scale=60.0,
                                       offset=200.0)
    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=32, cell_size=24, detect_margin=10,
                                klt=KLTConfig(levels=3, max_iterations=8)),
        window_size=4, image_shape=SHAPE)
    return cfg, frames, bench_scene.make_rig("cpu", shape=SHAPE, fx=100.0)


def _run(step, scene, n=FRAMES):
    cfg, frames, rig = scene
    state = est.init_state(cfg, device="cpu")
    for a, b in frames[:n]:
        state, _ = step(state, rig, a, b)


def test_off_records_nothing_and_builds_nothing():
    assert not profiling.on()
    spans = [profiling.span("x", frame=k) for k in range(3)]
    assert all(s is profiling._NULL for s in spans)
    with profiling.span("x") as sp:
        sp.set(is_kf=True)
        assert profiling.current() is None
    assert profiling.records() == ([], [])
    assert profiling.report() == ""


def test_spans_nest_with_parents_and_attributes():
    with profiling.recording():
        assert profiling.on()
        with profiling.span("step", step=7) as top:
            top.set(frame=3)
            with profiling.span("step.load") as mid:
                assert profiling.current() is mid
                with profiling.span("leaf", key=("motion", True)):
                    pass
    assert not profiling.on()
    spans = profiling.records().spans
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["leaf", "step.load", "step"]
    assert by["step"].parent is None
    assert by["step.load"].parent == by["step"].id
    assert by["leaf"].parent == by["step.load"].id
    assert by["leaf"].attrs == {"step": 7, "frame": 3,
                                "key": ("motion", True)}
    assert by["step.load"].attrs == {"step": 7, "frame": 3}
    for s in spans:
        assert s.start_ns <= s.end_ns
    assert by["step"].start_ns <= by["step.load"].start_ns \
        <= by["leaf"].start_ns <= by["leaf"].end_ns \
        <= by["step.load"].end_ns <= by["step"].end_ns


def test_report_sums_the_calling_threads_spans_since_the_last():
    with profiling.recording():
        for _ in range(2):
            with profiling.span("graph.replay"):
                time.sleep(0.002)
        line = profiling.report()
        assert profiling.report() == ""
    name, ms = line.split(" ")
    assert name == "graph.replay" and ms.endswith("ms")
    assert float(ms[:-2]) >= 4.0


def test_threads_keep_their_own_spans():
    n_threads, n_spans = 5, 50
    barrier = threading.Barrier(n_threads)

    def body(i):
        barrier.wait(timeout=10)
        for k in range(n_spans):
            with profiling.span("step", step=i, frame=k):
                with profiling.span("step.read"):
                    pass

    threads = [threading.Thread(target=body, args=(i,), name=f"stream{i}")
               for i in range(n_threads)]
    with profiling.recording():
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    spans = profiling.records().spans    # the threads have ended
    ids = {s.id: s for s in spans}
    for i in range(n_threads):
        mine = [s for s in spans if s.thread == f"stream{i}"]
        assert len(mine) == 2 * n_spans
        assert all(s.attrs["step"] == i for s in mine)
        reads = [s for s in mine if s.name == "step.read"]
        assert [s.attrs["frame"] for s in reads] == list(range(n_spans))
        assert all(ids[s.parent].thread == s.thread for s in reads)


def test_a_threads_buffer_keeps_its_newest_spans(monkeypatch):
    monkeypatch.setattr(profiling, "LIMIT", 10)

    def body():
        for k in range(25):
            with profiling.span("s", k=k):
                pass

    t = threading.Thread(target=body)
    with profiling.recording():
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert [s.attrs["k"] for s in profiling.records().spans] == \
        list(range(15, 25))


def test_stamps_match_the_profilers_own_annotations():
    """A span inside a CPU torch.profiler session enters
    record_function(name) and is stamped on the profiler's clock: each span
    lies inside its annotation, whose enter and exit add from a few to a
    hundred us around the span's stamps on a loaded host (the first one in
    a process ~1 ms: a warm-up span goes first), and the closest starts and
    ends lie within 50 us of the annotation's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.on()
        for k in range(9):
            with profiling.span(f"probe.{k}"):
                time.sleep(0.001)
    assert not profiling.on()
    spans = {s.name: s for s in profiling.records().spans}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe.")}
    assert sorted(events) == sorted(spans) and len(spans) == 9
    starts, ends = [], []
    for name, s in spans.items():
        e = events[name]
        e0, e1 = e.start_ns(), e.start_ns() + e.duration_ns()
        assert e0 - 5_000 <= s.start_ns < s.end_ns <= e1 + 5_000, name
        if name != "probe.0":
            starts.append(s.start_ns - e0)
            ends.append(e1 - s.end_ns)
    assert min(starts) < 50_000 and min(ends) < 50_000


def test_graphs_run_records_a_replay_span():
    g = Graphs("cpu")
    ran = []
    g.run(("a", 1), lambda: ran.append(1))       # off: nothing kept
    with profiling.recording():
        assert g.run(("a", 1), lambda: ran.append(2)) is None
    (s,) = profiling.records().spans
    assert ran == [1, 2]
    assert s.name == "graph.replay" and s.attrs == {"key": ("a", 1)}


def test_compiled_step_records_its_spans_once_a_frame(scene):
    step = est.make_compiled_estimator_step(scene[0], device="cpu")
    variants = []
    cfg, frames, rig = scene
    state = est.init_state(cfg, device="cpu")
    with profiling.recording():
        for a, b in frames:
            state, _ = step(state, rig, a, b)
            variants.append(step.last_variants)
    spans = profiling.records().spans
    assert [s.attrs["frame"] for s in spans if s.name == "step"] == \
        list(range(FRAMES))
    for k in range(FRAMES):
        mine = [s for s in spans if s.attrs.get("frame") == k]
        assert all(s.attrs["step"] == step.tag for s in mine)
        assert [s.name for s in mine] == [
            "step.load", "graph.replay", "step.read", "graph.replay",
            "step.emit", "step"]
        top = mine[-1]
        assert all(s.parent == top.id for s in mine[:-1])
        assert tuple(s.attrs["key"] for s in mine
                     if s.name == "graph.replay") == variants[k]
        assert top.attrs["is_kf"] == variants[k][1][1]
        assert top.attrs["solve"] == variants[k][1][2]


class FakeEvent:
    """A timing event on a stand-in device clock (ms); its reads are
    counted."""

    clock = 0.0
    reads = 0
    complete = True

    def __init__(self, **kw):
        self.t = None

    def record(self):
        self.t = FakeEvent.clock

    def query(self):
        FakeEvent.reads += 1
        return FakeEvent.complete

    def elapsed_time(self, other):
        FakeEvent.reads += 1
        return other.t - self.t


def _fake_device(step, monkeypatch, dur_ms, gap_ms):
    """The step's replays on a stand-in device: each variant's segment
    counts as a replay; the stream waits gap_ms before a replay and the
    replay of `key` takes dur_ms[key[0]]."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    run = step.graphs.run

    def replays(key):
        FakeEvent.clock += gap_ms
        return True

    def fake_run(key, fn):
        run(key, fn)
        FakeEvent.clock += dur_ms[key[0]]
    step._replays = replays
    step.graphs.run = fake_run
    FakeEvent.reads, FakeEvent.complete = 0, True


def test_device_spans_from_the_replays_events(scene, monkeypatch):
    step = est.make_compiled_estimator_step(scene[0], device="cpu")
    _fake_device(step, monkeypatch, {"motion": 2.5, "opt": 4.0}, 0.75)
    _run(step, scene, 2)                      # off: no event is read
    assert FakeEvent.reads == 0 and not profiling.records().spans
    with profiling.recording():
        _run(step, scene, 3)
    rec = profiling.records()
    # A call reads the replays before it: the last frame's are not read.
    dev = [d for d in rec.device if d.name == "graph.device"]
    gap = [d for d in rec.device if d.name == "stream.gap"]
    assert [(d.attrs["frame"], d.attrs["key"][0], d.attrs["layer"])
            for d in dev] == [
        (0, "motion", "motion"), (0, "opt", "keyframe"),
        (1, "motion", "motion"), (1, "opt", "keyframe")]
    assert [d.ns for d in dev] == [2_500_000, 4_000_000] * 2
    assert [d.ns for d in gap] == [750_000] * 3
    assert [(d.attrs["frame"], d.attrs["key"][0]) for d in gap] == [
        (0, "opt"), (1, "motion"), (1, "opt")]
    assert all(d.attrs["step"] == step.tag for d in dev + gap)


def test_device_spans_not_complete_wait_for_a_later_call(scene,
                                                         monkeypatch):
    step = est.make_compiled_estimator_step(scene[0], device="cpu")
    _fake_device(step, monkeypatch, {"motion": 1.0, "opt": 2.0}, 0.5)
    FakeEvent.complete = False
    with profiling.recording():
        _run(step, scene, 3)
        assert profiling.records().device == []
        FakeEvent.complete = True
        _run(step, scene, 1)
    # The first three frames' six replays, in order, with the gaps between.
    rec = profiling.records()
    assert [(d.name, d.attrs["frame"], d.attrs["key"][0])
            for d in rec.device][:4] == [
        ("graph.device", 0, "motion"), ("stream.gap", 0, "opt"),
        ("graph.device", 0, "opt"), ("stream.gap", 1, "motion")]
    assert sum(d.name == "graph.device" for d in rec.device) == 6
    assert sum(d.name == "stream.gap" for d in rec.device) == 5
