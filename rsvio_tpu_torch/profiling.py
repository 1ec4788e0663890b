"""Per-stage timing spans — the instrumentation surface of the reference's
[Timing] log line (ref src/estimator/estimator.rs:108-122, 252-259) — and a
torch.profiler trace.

Port of rsvio_tpu/profiling.py: ``span`` / ``report`` as there;
``torch_trace`` takes the place of ``jax_trace``.

Usage:
    with profiling.span("patch_tracking"):
        ...
    log.debug(profiling.report())   # "patch_tracking 3.2ms | ..."
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

_current: "OrderedDict[str, float]" = OrderedDict()


@contextlib.contextmanager
def span(name: str):
    t0 = time.time()
    try:
        yield
    finally:
        _current[name] = (time.time() - t0) * 1000.0


def report() -> str:
    out = " | ".join(f"{k} {v:.1f}ms" for k, v in _current.items())
    _current.clear()
    return out


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Wrap a region in a torch.profiler trace (CPU activity, and CUDA
    activity when a device is present) and write it as a Chrome trace,
    ``<logdir>/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
