"""The arithmetic of the per-layer readings taken from the program's own
records (program_trace.py), on synthetic records: two streams' frames with
known launch, wait, device and gap times; frames recorded in part (a
capture, a replay whose device record was not read, a step span missing)
left out; every reading None with no records or with a program that has no
tracer."""

from __future__ import annotations

import itertools
import types

import pytest

from portbench import program_trace
from rsvio_tpu_torch.profiling import Device, Records, Span

MS = 1_000_000
_ids = itertools.count(1)


def _span(name, t0_ms, t1_ms, **attrs):
    return Span(next(_ids), None, name, round(t0_ms * MS), round(t1_ms * MS),
                "t", attrs)


def _dev(name, len_ms, **attrs):
    return Device(name, round(len_ms * MS), "t", attrs)


def _frame(step, frame, t, keys, launch, read, dev, gap, solve=False,
           capture=None):
    """One frame's records from t (ms): a replay of each key taking `launch`
    ms on the host, the read after the first, and each replay's device
    record (`dev` by the key's first item; None: not read) after a gap."""
    a = dict(step=step, frame=frame)
    out = [_span("step", t, t + 50, ready=True, is_kf=solve, solve=solve,
                 **a)]
    host = t + 1
    for i, key in enumerate(keys):
        name = "graph.capture" if key == capture else "graph.replay"
        out.append(_span(name, host, host + launch, key=key, **a))
        host += launch
        if i == 0:
            out.append(_span("step.read", host, host + read, **a))
            host += read
        if name == "graph.replay" and dev.get(key[0]) is not None:
            layer = "motion" if i == 0 else "keyframe"
            out.append(_dev("graph.device", dev[key[0]], key=key,
                            layer=layer, **a))
            out.append(_dev("stream.gap", gap, key=key, layer=layer, **a))
    return out


def _records(items):
    return Records([s for s in items if isinstance(s, Span)],
                   [d for d in items if isinstance(d, Device)])


VO = dict(motion=("motion", True), opt=("opt", True, True),
          other=("opt", False, False))


def _vo_records():
    items = []
    # Stream 0: a plain frame and a solve frame; stream 1 the same, later.
    for step, t in ((0, 0.0), (1, 20.0)):
        items += _frame(step, 10, t, [VO["motion"], VO["other"]], 2.0, 3.0,
                        {"motion": 6.0, "opt": 0.5}, 4.0)
        items += _frame(step, 11, t + 100, [VO["motion"], VO["opt"]], 4.0,
                        5.0, {"motion": 8.0, "opt": 20.0}, 2.0, solve=True)
    # Left out: a frame whose K was captured, one whose K device record was
    # not read, and records of a frame whose step span was not recorded.
    items += _frame(0, 12, 300, [VO["motion"], VO["opt"]], 4.0, 5.0,
                    {"motion": 8.0, "opt": 90.0}, 2.0, solve=True,
                    capture=VO["opt"])
    items += _frame(0, 13, 400, [VO["motion"], VO["opt"]], 4.0, 5.0,
                    {"motion": 8.0, "opt": None}, 2.0, solve=True)
    items += [s for s in _frame(1, 14, 500, [VO["motion"], VO["other"]],
                                9.0, 9.0, {"motion": 9.0}, 9.0)
              if s.name != "step"]
    return _records(items)


def test_frame_readings_of_two_vo_streams():
    fr = program_trace.Frames(_vo_records())
    assert sorted(fr.step) == [(0, 10), (0, 11), (0, 12), (0, 13), (1, 10),
                               (1, 11)]
    # launch: 4, 8, 4 (the captured K is no replay), 8; 4, 8
    assert program_trace.launch_ms(fr) == pytest.approx(6.0)
    assert program_trace.kf_read_wait_ms(fr) == pytest.approx(5.0)
    # every frame's segment M: 6, 8, 8, 8, 6, 8
    assert program_trace.motion_device_ms(fr) == pytest.approx(8.0)
    # solve frames read whole: (0, 11) and (1, 11), 20 ms each
    assert program_trace.solve_device_ms(fr) == pytest.approx(20.0)
    # frames read whole: 4 + 4 (plain), 2 + 2 (solve) on both streams
    assert program_trace.stream_gap_ms(fr) == pytest.approx(6.0)


def test_vio_solve_sums_the_preintegration_and_the_solve():
    key = dict(front=("front", True, 16), pre=("kf_pre", 64),
               kf=("kf", True, True))
    fr = program_trace.Frames(_records(_frame(
        3, 5, 0.0, [key["front"], key["pre"], key["kf"]], 1.0, 1.0,
        {"front": 7.0, "kf_pre": 3.0, "kf": 40.0}, 0.5, solve=True)))
    assert program_trace.solve_device_ms(fr) == pytest.approx(43.0)
    assert program_trace.motion_device_ms(fr) == pytest.approx(7.0)
    assert program_trace.stream_gap_ms(fr) == pytest.approx(1.5)


def test_launch_busy_is_the_union_of_the_threads_launches():
    spans = [_span("step", 0, 100, step=0, frame=0),
             _span("graph.replay", 10, 30, key=("motion", True)),
             _span("graph.replay", 20, 40, key=("motion", True)),  # overlap
             _span("graph.replay", 60, 70, key=("opt", False, False))]
    assert program_trace.launch_busy_pct(spans) == pytest.approx(40.0)


def test_readings_find_nothing_without_records(monkeypatch):
    run = types.SimpleNamespace(program_records=_records([]))
    assert program_trace.frames_of(run) is None
    assert program_trace.launch_busy_pct([]) is None
    only = _records([_span("graph.replay", 0, 1, key=("motion", True))])
    assert program_trace.frames_of(
        types.SimpleNamespace(program_records=only)) is None
    # A program without records() (the parent of this tracer): None.
    import rsvio_tpu_torch.profiling as prof
    monkeypatch.delattr(prof, "records")
    run = types.SimpleNamespace()
    assert program_trace.records_of(run) is None
    assert program_trace.frames_of(run) is None
