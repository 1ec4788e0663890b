"""Mono feature tracker: temporal bidirectional KLT + Shi-Tomasi births, no
stereo.

Port of rsvio_tpu/models/mono_tracker.py, built from the same batched
primitives as the stereo frontend (``birth_slots``, ``masked_row_scatter``).
Per frame after the first: one bidirectional KLT pass (one kernel launch on
the kernel route), then Shi-Tomasi scoring and grid or NMS selection of new
corners into free table slots.

``make_compiled_mono_step`` is the counterpart of JAX's jitted
``mono_tracker_step`` (``first_frame`` a static argument): the pyramid build
and the step as one CUDA graph for each of the two ``first_frame`` variants,
over fixed buffers, with no read of the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import detect, klt
from ..utils import graphs as graph_mod
from ..utils.precision import pin_fp32
from .estimator import KERNEL_COUNTERS
from .frontend import birth_slots, masked_row_scatter


class MonoTrackerConfig(NamedTuple):
    """Same fields and defaults as the JAX MonoTrackerConfig."""
    capacity: int = 256
    cell_size: int = 30
    detect_margin: int = 19
    min_score: float = 1.0
    klt: klt.KLTConfig = klt.KLTConfig(max_iterations=30,
                                       convergence_threshold=0.005)
    detect_mode: str = "grid"
    nms_radius: int = 10
    nms_max_new: int = 128


class MonoTable(NamedTuple):
    pos: torch.Tensor      # (N,2) positions (full-res px)
    A: torch.Tensor        # (N,2,2) warp linear part
    fid: torch.Tensor      # (N,) int32 feature ids (unique, never reused)
    alive: torch.Tensor    # (N,) bool
    age: torch.Tensor      # (N,) int32 frames tracked
    next_id: torch.Tensor  # () int32


def init_mono_table(capacity: int, dtype=torch.float32,
                    device="cuda") -> MonoTable:
    return MonoTable(
        pos=torch.zeros((capacity, 2), dtype=dtype, device=device),
        A=torch.eye(2, dtype=dtype, device=device).expand(capacity, 2, 2)
        .clone(),
        fid=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        alive=torch.zeros(capacity, dtype=torch.bool, device=device),
        age=torch.zeros(capacity, dtype=torch.int32, device=device),
        next_id=torch.tensor(0, dtype=torch.int32, device=device))


def mono_tracker_step(table: MonoTable, pyr_prev, pyr_cur,
                      cfg: MonoTrackerConfig, first_frame: bool = False):
    """One frame: temporal bidirectional KLT (skipped on the first frame),
    then Shi-Tomasi births. Returns (new_table, stats dict of 0-d
    tensors)."""
    if cfg.detect_mode not in ("grid", "nms"):
        raise ValueError(f"unknown detect_mode {cfg.detect_mode!r}")
    if first_frame:
        survived = torch.zeros_like(table.alive)
        pos, A = table.pos, table.A
    else:
        pos, A, ok = klt.track_points_bidirectional(
            pyr_prev, pyr_cur, table.pos, table.alive, cfg.klt)
        survived = table.alive & ok
    table = table._replace(
        pos=pos, A=A, alive=survived,
        age=torch.where(survived, table.age + 1, torch.zeros_like(table.age)))

    score = detect.shi_tomasi_score(pyr_cur[0])
    if cfg.detect_mode == "nms":
        cand_xy, cand_ok = detect.nms_select(
            score, table.pos, table.alive, cfg.nms_radius,
            margin=cfg.detect_margin, min_score=cfg.min_score,
            max_new=cfg.nms_max_new)
    else:
        cand_xy, cand_ok = detect.select_grid_features(
            score, table.pos, table.alive, cfg.cell_size,
            margin=cfg.detect_margin, min_score=cfg.min_score)

    C = cand_ok.shape[0]
    dev = cand_ok.device
    slot, ok, rank = birth_slots(table.alive, cand_ok)
    scat = lambda arr, upd: masked_row_scatter(arr, slot, ok, upd)  # noqa: E731
    eye = torch.eye(2, dtype=table.A.dtype, device=dev).expand(C, 2, 2)
    table = table._replace(
        pos=scat(table.pos, cand_xy), A=scat(table.A, eye),
        fid=scat(table.fid, table.next_id + rank),
        alive=scat(table.alive, torch.ones(C, dtype=torch.bool, device=dev)),
        age=scat(table.age, torch.zeros(C, dtype=torch.int32, device=dev)),
        next_id=table.next_id + ok.to(torch.int32).sum(dtype=torch.int32))
    stats = {"tracked": survived.to(torch.int32).sum(dtype=torch.int32),
             "alive": table.alive.to(torch.int32).sum(dtype=torch.int32)}
    return table, stats


class CompiledMonoStep:
    """The mono tracker's frame as CUDA graphs (make_compiled_mono_step
    builds it): step(table, img, first_frame=False) -> (table, stats) with
    the results of ``mono_tracker_step(table, make_pyramid(img_prev),
    make_pyramid(img), cfg, first_frame)``.

    Each ``first_frame`` variant is one graph over the pyramid build and
    the step, replayed over fixed buffers: the table (copied in only when
    it is not the one this step returned last), the image, and the
    previous frame's pyramid, which the graph reads and then overwrites
    with the current one. `pyramid` holds the current frame's levels
    (views, valid until the next call). Results come back in one of two
    output buffers used in turn (valid through the next call). The step
    reads nothing from the device (`host_reads` stays 0). On CUDA a failed
    capture or replay raises utils.graphs.GraphError; on the CPU
    (device="cpu") the same function runs eagerly over the same buffers."""

    def __init__(self, cfg: MonoTrackerConfig, make_pyramid, device):
        self.cfg, self.make_pyramid = cfg, make_pyramid
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_compiled_mono_step: no CUDA device is "
                               "available; pass device='cpu' to run the "
                               "step eagerly on the CPU")
        self.graphs = graph_mod.Graphs(self.device, KERNEL_COUNTERS)
        self.host_reads = 0
        self.pyramid = None
        self._in = self._img = self._pyr = self._new = None
        self._out, self._turn, self._last = None, 0, None

    def _frame(self, first_frame: bool):
        def fn():
            pyr = self.make_pyramid(self._img.tree)
            prev = pyr if first_frame else self._pyr.tree
            res = mono_tracker_step(self._in.tree, prev, pyr, self.cfg,
                                    first_frame=first_frame)
            if self._pyr is None:
                self._pyr = graph_mod.Slab(pyr, self.device)
            self._pyr.load(pyr)
            if self._new is None:
                self._new = graph_mod.Slab(res, self.device)
            self._new.load(res)
        return fn

    def __call__(self, table: MonoTable, img, first_frame: bool = False):
        dev = self.device
        if self._in is None:
            self._in = graph_mod.Slab(table, dev)
            self._img = graph_mod.Slab(img, dev)
        if not first_frame and self._pyr is None:
            raise ValueError("the first call needs first_frame=True: there "
                             "is no previous pyramid yet")
        if table is not self._last:
            self._in.load(table)
        self._img.load(img)
        self.graphs.run(("mono", first_frame), self._frame(first_frame))
        if self._out is None:
            self._out = [graph_mod.Slab(self._new.template, dev)
                         for _ in range(2)]
        self._in.buf.copy_(self._new.buf[:self._in.nbytes])
        self._turn ^= 1
        out = self._out[self._turn]
        out.buf.copy_(self._new.buf)
        self._last, stats = out.fresh_tree()
        self.pyramid = self._pyr.tree
        return self._last, stats


def make_compiled_mono_step(cfg: MonoTrackerConfig, make_pyramid,
                            device="cuda"):
    """The mono tracker's frame, pyramid included, as CUDA graphs
    (CompiledMonoStep): the counterpart of the JAX package's jitted
    ``mono_tracker_step``. `make_pyramid(img)` -> tuple of levels (e.g.
    cli/run_tartanair.tracker_settings'). `device`: "cuda" (the default;
    raises without a card) or "cpu", where the same function runs eagerly.
    Pins full fp32 and validates the config."""
    if cfg.detect_mode not in ("grid", "nms"):
        raise ValueError(f"unknown detect_mode {cfg.detect_mode!r}")
    pin_fp32()
    return CompiledMonoStep(cfg, make_pyramid, device)
