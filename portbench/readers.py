"""What the per-layer metrics read, from a finished run (`run`, a
run.RunData). Each file under metrics/ names one metric and calls one of
these. A reader that finds nothing to read returns None, and the metric is
left out of the line."""

from __future__ import annotations

import numpy as np

from . import roofline


def captures_in_window(run):
    """Variants captured between the window's start and its end, over all
    streams (0 when warm-up met every variant)."""
    return float(run.captures_after - run.captures_before)


def _span_ms(run, kf: bool):
    ms = [(t1 - t0) * 1e3 for t0, t1, is_kf in run.spans if is_kf == kf]
    return float(np.median(ms)) if ms else None


def other_frame_ms(run):
    """Median host span of a frame (upload, step, pose on the host) whose
    output says no keyframe: segments M / F."""
    return _span_ms(run, False)


def kf_frame_ms(run):
    """Median host span of a keyframe frame: segments M / F, then K / P+K."""
    return _span_ms(run, True)


def keyframe_pct(run):
    if not run.spans:
        return None
    return 100.0 * sum(1 for s in run.spans if s[2]) / len(run.spans)


def device_idle_pct(run):
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernels_per_frame(run):
    t = run.trace
    if t is None or not run.slice_frames:
        return None
    return t["kernels"] / len(run.slice_frames)


def klt_roofline_pct(run):
    """The KLT kernel's (K1's) least time for the slice's frames over its
    time in the trace."""
    t = run.trace
    if t is None or t["k1_s"] <= 0 or not run.slice_frames:
        return None
    bound_s = sum(roofline.k1_frame_bound_s(run.levels, n_prev, n_alive,
                                            n_tracked)
                  for n_prev, n_alive, n_tracked in run.slice_frames)
    # The frames of the slice and the K1 launches in it may differ by a
    # frame at each end: compare per launch (two a frame).
    per_launch_bound = bound_s / (2 * len(run.slice_frames))
    per_launch = t["k1_s"] / t["k1_n"]
    return 100.0 * per_launch_bound / per_launch
