"""Marginalization prior container.

Only ``MargPrior`` and ``empty_prior`` are ported: the estimator state
carries an (empty) prior. Marginalizing evicted keyframes
(``use_marginalization``, ``solve_ba_marginalized``) is not ported yet
(ROADMAP A13).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MargPrior(NamedTuple):
    """Gaussian prior over the window states (block layout (W, W, B, B))."""
    H: torch.Tensor         # (W*B, W*B)
    g: torch.Tensor         # (W*B,)
    T0: torch.Tensor        # (W,4,4) linearization point, T_W_B
    x0_extra: torch.Tensor  # (W, B-6)
    valid: torch.Tensor     # () bool


def empty_prior(W: int, B: int, dtype=torch.float32,
                device="cuda") -> MargPrior:
    return MargPrior(
        H=torch.zeros((W * B, W * B), dtype=dtype, device=device),
        g=torch.zeros(W * B, dtype=dtype, device=device),
        T0=torch.eye(4, dtype=dtype, device=device).expand(W, 4, 4).clone(),
        x0_extra=torch.zeros((W, max(B - 6, 0)), dtype=dtype, device=device),
        valid=torch.tensor(False, device=device),
    )
