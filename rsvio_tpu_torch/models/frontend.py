"""Stereo feature-tracking frontend: fixed-capacity masked feature table and
the per-frame update.

Port of rsvio_tpu/models/frontend.py. Per frame: temporal bidirectional
tracking of both cameras (one kernel launch on the kernel route), FAST-9
scoring and grid selection (``detect_mode="grid"``) or block NMS
(``"nms"``) on cam0, stereo matching of the candidates cam0 -> cam1 (a
second launch), and births into free table slots. All shapes are static;
births compact into free slots through a stable argsort and a cumsum, with
no data-dependent shapes and no host sync.

The starvation floor (``relax_floor_below > 0``) stays on the device: the
starving flag is a tensor, grid mode computes both selections and picks one
with ``torch.where``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import detect, klt


class FrontendConfig(NamedTuple):
    """Same fields and defaults as the JAX FrontendConfig."""
    capacity: int = 256
    cell_size: int = 50
    detect_margin: int = 19
    min_score: float = 10.0
    max_per_cell: int = 1
    klt: klt.KLTConfig = klt.KLTConfig()
    detect_mode: str = "grid"
    nms_radius: int = 10
    nms_max_new: int = 128
    relax_floor_below: int = 0
    relaxed_min_score: float = 1.0
    relax_max_per_cell: int = 3
    score_weight_floor: float = 0.05
    score_weight_ref: float = 10.0
    score_weight_power: float = 1.0


def check_config(cfg: FrontendConfig) -> None:
    """Raise for options the port does not implement yet and for unknown
    values."""
    if cfg.detect_mode not in ("grid", "nms"):
        raise ValueError(f"unknown detect_mode {cfg.detect_mode!r}")
    klt.resolve_backend(cfg.klt)


class FeatureTable(NamedTuple):
    """Struct-of-arrays track state, N = capacity."""
    pos0: torch.Tensor     # (N,2) cam0 positions (full-res px)
    pos1: torch.Tensor     # (N,2) cam1 positions
    A0: torch.Tensor       # (N,2,2) cam0 warp linear part
    A1: torch.Tensor       # (N,2,2) cam1 warp linear part
    fid: torch.Tensor      # (N,) int32 feature ids (unique, never reused)
    alive: torch.Tensor    # (N,) bool
    age: torch.Tensor      # (N,) int32 frames tracked
    w: torch.Tensor        # (N,) birth-score observation weight
    next_id: torch.Tensor  # () int32


def init_table(capacity: int, dtype=torch.float32,
               device="cuda") -> FeatureTable:
    N = capacity
    eye = torch.eye(2, dtype=dtype, device=device).expand(N, 2, 2).clone()
    return FeatureTable(
        pos0=torch.zeros((N, 2), dtype=dtype, device=device),
        pos1=torch.zeros((N, 2), dtype=dtype, device=device),
        A0=eye, A1=eye.clone(),
        fid=torch.full((N,), -1, dtype=torch.int32, device=device),
        alive=torch.zeros(N, dtype=torch.bool, device=device),
        age=torch.zeros(N, dtype=torch.int32, device=device),
        w=torch.ones(N, dtype=dtype, device=device),
        next_id=torch.tensor(0, dtype=torch.int32, device=device),
    )


def birth_slots(alive, cand_ok):
    """Assign accepted candidates to free table slots.

    Returns (slot (C,), ok (C,), rank (C,)): the target row per candidate
    (N when rejected or the table is full), whether it lands, and its rank
    among accepted candidates. The free slots are the first C indices of
    ~alive in ascending order, padded with N — what
    ``jnp.nonzero(~alive, size=C, fill_value=N)`` gives — built from a
    stable argsort so the shape never depends on the data.
    """
    N = alive.shape[0]
    C = cand_ok.shape[0]
    dev = alive.device
    order = torch.argsort(alive.to(torch.int8), stable=True)   # free first
    n_free = (~alive).sum()
    k = torch.arange(max(C, N), device=dev)
    padded = torch.cat([order, torch.full((max(C - N, 0),), N,
                                          dtype=order.dtype, device=dev)])
    free_slots = torch.where(k < n_free, padded, N)[:C]
    rank = torch.cumsum(cand_ok.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(cand_ok, free_slots[torch.clamp(rank, 0, C - 1)
                                           .to(torch.int64)], N)
    ok = cand_ok & (slot < N)
    return slot, ok, rank


def masked_row_scatter(arr, slot, ok, upd):
    """arr[slot[i]] <- upd[i] where ok[i], on a copy. Rejected rows land on a
    dummy padding row past the end, never on a real index, so they cannot
    overwrite a birth into the last slot; duplicate writes to the dummy row
    are harmless because it is dropped."""
    N = arr.shape[0]
    idx = torch.where(ok, slot, N).to(torch.int64)
    padded = torch.cat([arr, arr[-1:]], dim=0)
    padded[idx] = upd.to(arr.dtype)
    return padded[:N]


def _insert_births(table: FeatureTable, cand0, cand1, cand_A1, cand_ok,
                   cand_w=None) -> FeatureTable:
    """Compact accepted candidates (C,) into free table slots."""
    slot, ok, rank = birth_slots(table.alive, cand_ok)
    C = cand_ok.shape[0]
    dev = cand_ok.device
    scat = lambda arr, upd: masked_row_scatter(arr, slot, ok, upd)  # noqa: E731
    eye = torch.eye(2, dtype=table.A0.dtype, device=dev).expand(C, 2, 2)
    if cand_w is None:
        cand_w = torch.ones(C, dtype=table.w.dtype, device=dev)
    n_born = ok.to(torch.int32).sum(dtype=torch.int32)
    return table._replace(
        pos0=scat(table.pos0, cand0), pos1=scat(table.pos1, cand1),
        A0=scat(table.A0, eye), A1=scat(table.A1, cand_A1),
        fid=scat(table.fid, table.next_id + rank),
        alive=scat(table.alive, torch.ones(C, dtype=torch.bool, device=dev)),
        age=scat(table.age, torch.zeros(C, dtype=torch.int32, device=dev)),
        w=scat(table.w, cand_w),
        next_id=table.next_id + n_born)


def frontend_step(table: FeatureTable, pyr0_prev, pyr1_prev, pyr0, pyr1,
                  cfg: FrontendConfig):
    """One frame of stereo feature tracking.

    table holds tracks valid for the previous frame; pyramids are tuples of
    (H_l, W_l) levels. Returns (new_table, stats dict of 0-d tensors).
    """
    check_config(cfg)
    kcfg = cfg.klt

    # (b) temporal tracking of both cameras in one launch; a feature
    # survives only if both temporal tracks pass the bidirectional gate.
    pos0, A0, ok0, pos1, A1, ok1 = klt.track_points_bidirectional_stereo(
        pyr0_prev, pyr1_prev, pyr0, pyr1, table.pos0, table.pos1,
        table.alive, kcfg)
    survived = table.alive & ok0 & ok1
    table = table._replace(
        pos0=pos0, pos1=pos1, A0=A0, A1=A1, alive=survived,
        age=torch.where(survived, table.age + 1, torch.zeros_like(table.age)))

    # (c) detect new corners on cam0 level 0, away from live tracks.
    score = detect.fast_score(pyr0[0])
    starving = None
    floor = cfg.min_score
    if cfg.relax_floor_below > 0:
        # Starvation floor: too few live tracks lower the score floor.
        starving = table.alive.sum() < cfg.relax_floor_below
        floor = torch.where(
            starving, torch.full((), cfg.relaxed_min_score,
                                 dtype=score.dtype, device=score.device),
            torch.full((), cfg.min_score, dtype=score.dtype,
                       device=score.device))
    if cfg.detect_mode == "nms":
        cand_xy, cand_ok = detect.nms_select(
            score, table.pos0, table.alive, cfg.nms_radius,
            margin=cfg.detect_margin, min_score=floor,
            max_new=cfg.nms_max_new)
    elif starving is None:
        cand_xy, cand_ok = detect.select_grid_features(
            score, table.pos0, table.alive, cfg.cell_size,
            margin=cfg.detect_margin, min_score=cfg.min_score,
            max_per_cell=cfg.max_per_cell)
    else:
        # Both selections at k picks per cell, one chosen on the device:
        # strict = cell occupancy, the first max_per_cell picks, the strict
        # floor; starving = distance occupancy, all k picks, the relaxed
        # floor.
        k = max(cfg.max_per_cell, cfg.relax_max_per_cell)
        xy_s, ok_s = detect.select_grid_features(
            score, table.pos0, table.alive, cfg.cell_size,
            margin=cfg.detect_margin, min_score=cfg.min_score,
            max_per_cell=k, cell_occupancy=True)
        n_cells = ok_s.shape[0] // k
        rnd = torch.arange(ok_s.shape[0], device=ok_s.device) // n_cells
        ok_s = ok_s & (rnd < cfg.max_per_cell)
        xy_r, ok_r = detect.select_grid_features(
            score, table.pos0, table.alive, cfg.cell_size,
            margin=cfg.detect_margin, min_score=cfg.relaxed_min_score,
            max_per_cell=k, cell_occupancy=False)
        cand_xy = torch.where(starving, xy_r, xy_s)
        cand_ok = torch.where(starving, ok_r, ok_s)

    # (d) stereo-match candidates cam0 -> cam1 (second launch).
    cand_pos1, cand_A1, stereo_ok = klt.track_points_bidirectional(
        pyr0, pyr1, cand_xy, cand_ok, kcfg)

    # (e) births: stereo-matched candidates only, weighted by their score.
    births_ok = cand_ok & stereo_ok
    H0, W0 = score.shape
    iy = torch.clamp(torch.round(cand_xy[:, 1]).to(torch.int64), 0, H0 - 1)
    ix = torch.clamp(torch.round(cand_xy[:, 0]).to(torch.int64), 0, W0 - 1)
    cand_w = torch.clamp(
        torch.pow(torch.clamp(score[iy, ix], min=1e-6) / cfg.score_weight_ref,
                  cfg.score_weight_power),
        cfg.score_weight_floor, 1.0)
    table = _insert_births(table, cand_xy, cand_pos1, cand_A1, births_ok,
                           cand_w)

    stats = {
        "tracked": survived.to(torch.int32).sum(dtype=torch.int32),
        "born": births_ok.to(torch.int32).sum(dtype=torch.int32),
        "alive": table.alive.to(torch.int32).sum(dtype=torch.int32),
    }
    return table, stats
