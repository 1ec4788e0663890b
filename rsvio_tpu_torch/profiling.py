"""The port's in-process tracer: spans, recorded only while a
torch.profiler session records or inside ``recording()``, and a
torch.profiler trace.

Port of rsvio_tpu/profiling.py, whose ``span`` / ``report`` fill the
reference's [Timing] log line (ref src/estimator/estimator.rs:108-122,
252-259); ``torch_trace`` takes the place of ``jax_trace``.

- ``span(name, **attrs)``: a context manager that records the span's name,
  start and end (``time.time_ns()``, the clock of torch.profiler's
  ``start_ns()``), the span it runs inside (its parent) and its
  attributes. ``records()`` gives each span its ancestors' attributes
  under its own, so the spans of one frame of one compiled step share that
  step's ``step`` and ``frame``. Inside a profiler session the span also
  enters ``torch.profiler.record_function(name)``, so a Chrome trace shows
  it over the CUDA calls of its thread (the profiler keeps the
  annotations of the thread that started it only).
- ``DeviceSpans``: a compiled step's graph replays, timed by events the
  step records on its stream around each replay while the tracer is on,
  as ``Device`` records (``graph.device`` and ``stream.gap``): lengths on
  the device's clock, with the replay's attributes and no place on the
  host's clock.

- ``counter(group, fields, device)``: a device buffer of int64 sums that a
  compiled step adds to inside its graphs (one in-place add, no host
  read), registered here so that it outlives the step; ``counter_sums()``
  reads every registered buffer once and gives each field's sum over them
  as ``"<group>.<field>"``. Counters count whether the tracer is on or
  off.

The tracer is on while ``torch.autograd.profiler._is_profiler_enabled``
(a profiler session records, on any thread) or inside ``recording()``.
Off, a span costs a flag read and returns one shared null context: nothing
is built, stamped or kept. Each thread keeps its records in a buffer of its
own, bounded to its newest LIMIT spans and registered globally, so the
records outlive the thread; ``records()`` reads every buffer and
``clear()`` empties them.

Usage:
    with profiling.recording():
        with profiling.span("patch_tracking", frame=k):
            ...
        log.debug(profiling.report())   # "patch_tracking 3.2ms | ..."
    spans, device = profiling.records()
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _prof

LIMIT = 1 << 16       # spans, and device records, a thread keeps (its newest)


class Span(NamedTuple):
    id: int
    parent: Optional[int]   # the id of the span it ran inside
    name: str
    start_ns: int           # time.time_ns()
    end_ns: int
    thread: str
    attrs: dict


class Device(NamedTuple):
    name: str               # graph.device or stream.gap
    ns: int                 # its length, on the device's clock
    thread: str
    attrs: dict             # key, layer, and the step span's step and frame


class Records(NamedTuple):
    spans: list             # Span, attributes merged down from ancestors
    device: list            # Device


class _Buffer:
    """One thread's records."""

    def __init__(self):
        self.owner = threading.current_thread()
        self.thread = self.owner.name
        self.spans = collections.deque(maxlen=LIMIT)
        self.device = collections.deque(maxlen=LIMIT)
        self.stack = []         # open spans, innermost last
        self.added = 0          # spans appended so far (report's cursor)
        self.reported = 0

    def add(self, span: Span):
        self.spans.append(span)
        self.added += 1


_lock = threading.Lock()        # guards _buffers, _counters, _recording
_buffers = []
_counters = []      # (group, fields, int64 buffer) of every counter made
_local = threading.local()
_recording = 0
_ids = itertools.count(1)


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = _Buffer()
        with _lock:
            _buffers.append(buf)
    return buf


def on() -> bool:
    """Whether spans are recorded now."""
    return bool(_recording or _prof._is_profiler_enabled)


@contextlib.contextmanager
def recording():
    """Record spans inside this block, on every thread."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


class _Null:
    """The span of an off tracer: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NULL = _Null()


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "attrs", "id", "parent", "start", "buf", "rf")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        buf = self.buf = _buffer()
        self.id = next(_ids)
        self.parent = buf.stack[-1].id if buf.stack else None
        self.rf = None
        if _prof._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        buf.stack.append(self)
        self.start = time.time_ns()
        return self

    def set(self, **attrs):
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        end = time.time_ns()
        buf = self.buf
        buf.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        buf.add(Span(self.id, self.parent, self.name, self.start, end,
                     buf.thread, self.attrs))
        return False


def span(name: str, **attrs):
    """A span of the calling thread; see the module docstring."""
    if not (_recording or _prof._is_profiler_enabled):
        return _NULL
    return _Open(name, attrs)


def current():
    """The innermost span open on this thread (None when there is none or
    the tracer is off)."""
    buf = getattr(_local, "buf", None)
    return buf.stack[-1] if buf is not None and buf.stack else None


def records() -> Records:
    """Every thread's spans and device records (oldest first within a
    thread)."""
    with _lock:
        bufs = list(_buffers)
    spans = [s for b in bufs for s in list(b.spans)]
    by_id = {s.id: s for s in spans}
    merged = {}

    def attrs(s):
        if s.id not in merged:
            up = by_id.get(s.parent)
            merged[s.id] = {**attrs(up), **s.attrs} if up else dict(s.attrs)
        return merged[s.id]

    return Records([s._replace(attrs=attrs(s)) for s in spans],
                   [d for b in bufs for d in list(b.device)])


def clear():
    """Empty every buffer; forget those of threads that have ended. Zero
    every counter (in place: a step goes on adding to its own)."""
    with _lock:
        _buffers[:] = [b for b in _buffers if b.owner.is_alive()]
        for b in _buffers:
            b.spans.clear()
            b.device.clear()
            b.added = b.reported = 0
        for _, _, buf in _counters:
            buf.zero_()


def counter(group: str, fields: tuple, device) -> torch.Tensor:
    """A new zeroed int64 buffer of len(fields) sums on `device`, registered
    under `group` for the life of the process; its maker adds to it in
    place."""
    buf = torch.zeros(len(fields), dtype=torch.int64, device=device)
    with _lock:
        _counters.append((group, tuple(fields), buf))
    return buf


def counter_sums() -> dict:
    """Every registered counter's sums, added over the buffers of a group
    (one per step that made it), as {"<group>.<field>": int}, read once
    every device has finished the work queued so far. Empty when no counter
    was made. The sums cover every step this process made since the last
    clear(), warm-up's frames included: a process that runs several
    configurations or runs one after another mixes their counts unless it
    calls clear() between them, once their steps' queued work is done."""
    with _lock:
        regs = list(_counters)
    for d in {buf.device for _, _, buf in regs if buf.device.type == "cuda"}:
        torch.cuda.synchronize(d)
    out = {}
    for group, fields, buf in regs:
        for f, v in zip(fields, buf.tolist()):
            key = f"{group}.{f}"
            out[key] = out.get(key, 0) + v
    return out


def report() -> str:
    """The calling thread's spans since its last report() (one frame, as
    cli/run calls it once a frame), their times summed by name:
    "step 21.3ms | step.load 0.2ms | ..." ("" when none)."""
    buf = getattr(_local, "buf", None)
    if buf is None:
        return ""
    new = min(buf.added - buf.reported, len(buf.spans))
    buf.reported = buf.added
    ms = {}
    for s in list(buf.spans)[len(buf.spans) - new:]:
        ms[s.name] = ms.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-6
    return " | ".join(f"{k} {v:.1f}ms" for k, v in ms.items())


class DeviceSpans:
    """The device side of one step's graph replays, from the timing events
    it records on its stream just before and after each replay, as
    ``Device`` records of the step's thread:

    - ``graph.device``: a replay's start event to its end event (with the
      launch, when the stream was idle at it);
    - ``stream.gap``: the previous replay's end event to this replay's
      start event: how long the stream's device work waited on its host
      thread.

    The step calls ``replayed`` after each replay while the tracer is on,
    and ``settle`` at the start of its next call, which reads the replays
    whose end has completed (``query()``; nothing here waits for the device)
    and keeps the rest for a later call; ``discard`` forgets them unread
    (the tracer was turned off). Each replay has events of its own, so none
    is recorded again before it is read."""

    def __init__(self):
        self.items = []    # (start event, end event, attrs) not yet read
        self.prev = None   # the end event of the last replay read

    def replayed(self, events, **attrs):
        cur = current()
        if cur is not None:
            attrs.update((k, cur.attrs[k]) for k in ("step", "frame")
                         if k in cur.attrs)
        self.items.append((events[0], events[1], attrs))

    def settle(self):
        while self.items and self.items[0][1].query():
            start, end, attrs = self.items.pop(0)
            buf = _buffer()
            if self.prev is not None:
                buf.device.append(Device("stream.gap",
                                         _ns(self.prev.elapsed_time(start)),
                                         buf.thread, attrs))
            buf.device.append(Device("graph.device",
                                     _ns(start.elapsed_time(end)),
                                     buf.thread, attrs))
            self.prev = end

    def discard(self):
        self.items.clear()
        self.prev = None


def _ns(ms: float) -> int:
    return round(ms * 1e6)


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Wrap a region in a torch.profiler trace (CPU activity, and CUDA
    activity when a device is present) and write it as a Chrome trace,
    ``<logdir>/trace.json``. The tracer is on inside it: the compiled
    steps' spans show over their CUDA calls."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
