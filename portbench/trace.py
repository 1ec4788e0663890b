"""The device trace of a run's traced slice, reduced to what the per-layer
readers take: device busy time (the union of every kernel, copy and set
interval over all CUDA streams), kernel counts, the KLT kernel's time, the
operations that took most time and the longest idle gaps with the host's
CUDA calls in progress across them (calls of 20 us or more)."""

from __future__ import annotations

import threading
import time

import torch

K1_NAME = "klt_bidir_kernel"


class Slice:
    """torch.profiler over the end of the window, from a helper thread of
    its own: the profiler is started and stopped by one thread (its state
    is the thread's), and no thread that drives frames waits for it.
    init(), in set-up, starts the helper, which starts and stops a
    profiler once (the first start initializes CUPTI and takes seconds);
    arm(t) has it start the slice's profiler at perf_counter time t; stop(),
    once the window's work is done, has it stop. The CUDA activity of
    every thread and stream is kept; the slice is from the profiler's start
    to its stop."""

    def __init__(self):
        self.prof = None
        self.t_arm = self.t_start = self.t_stop = None
        self.start_s = 0.0
        self._thread = None
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._go = threading.Event()
        self._error = None
        self.init_s = 0.0

    @staticmethod
    def _profile():
        return torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])

    def _run(self, at: float):
        try:
            t = time.perf_counter()
            warm = self._profile()      # the first start initializes CUPTI
            warm.start()
            warm.stop()
            self.init_s = time.perf_counter() - t
            self._ready.set()
            self._go.wait()
            time.sleep(max(0.0, self.t_arm - time.perf_counter()))
            t = time.perf_counter()
            self.prof = self._profile()
            self.prof.start()
            self.t_start = time.perf_counter()
            self.start_s = self.t_start - t
            self._stop.wait()
            # Every stream's thread has stopped; a capture in the window may
            # have left the process-wide sync-debug mode at "error".
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            self.t_stop = time.perf_counter()
            self.prof.stop()
        except BaseException as e:     # re-raised by init() or stop()
            self._error = e
            self._ready.set()

    def init(self):
        """Start the helper and let it initialize the profiler (set-up)."""
        self._thread = threading.Thread(target=self._run, args=(0.0,),
                                        daemon=True)
        self._thread.start()
        self._ready.wait()
        if self._error is not None:
            raise self._error

    def arm(self, at: float):
        self.t_arm = at
        self._go.set()

    def stop(self):
        self._stop.set()
        self._thread.join()
        if self._error is not None:
            raise self._error

    def reduce(self) -> dict:
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             self.t_stop - self.t_start)


def _union(intervals):
    total, cur_s, cur_e = 0, None, None
    gaps = []
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def reduce_events(events, window_s: float) -> dict:
    dev, host = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
        elif e.name().startswith("cuda") and e.duration_ns() >= 20_000:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.name()))
    busy_ns, gaps = _union([(s, e) for s, e, _ in dev])
    by_name = {}
    n_kernels, k1_ns, k1_n = 0, 0, 0
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
        if "memcpy" not in name.lower() and "memset" not in name.lower():
            n_kernels += 1
        if K1_NAME in name:
            k1_ns += e - s
            k1_n += 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    labelled = []
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        names = sorted({n for s, e, n in host if s <= mid <= e})
        labelled.append(["+".join(names[:3]) or "no_cuda_call",
                         (ge - gs) * 1e-9])
    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "kernels": n_kernels, "k1_s": k1_ns * 1e-9, "k1_n": k1_n,
            "device_ops": [[n[:64], t * 1e-9] for n, t in ops],
            "idle_gaps": labelled}
