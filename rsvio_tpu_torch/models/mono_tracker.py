"""Mono feature tracker: temporal bidirectional KLT + Shi-Tomasi births, no
stereo.

Port of rsvio_tpu/models/mono_tracker.py, built from the same batched
primitives as the stereo frontend (``birth_slots``, ``masked_row_scatter``).
Per frame after the first: one bidirectional KLT pass (one kernel launch on
the kernel route), then Shi-Tomasi scoring and grid or NMS selection of new
corners into free table slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import detect, klt
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
