"""Carry the JAX package's rig and estimator states (VO and VIO) across to
the port.

This system's counterpart of carrying weights across: a test can start both
steps from the same mid-sequence state. The inputs are the JAX package's
``CameraRig`` / ``EstimatorState`` with numpy leaves (for example
``jax.tree_util.tree_map(np.asarray, state)``); any object with the same
field names works. Every field is carried by name, so the optional state
(the RANSAC gate's ``lm_birth`` and ``health_ema``), the table's weights
``w`` and ages, and an EUCM rig's parameters come across as they are; a
field the JAX state leaves None stays None. A VIO state's nested
``Preintegrated`` (leading dim W-1) and its 15-dim ``MargPrior`` come
across the same way. Nothing here imports JAX or rsvio_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.estimator import CameraRig, EstimatorState
from ..models.estimator_vio import VIOEstimatorState
from ..models.frontend import FeatureTable
from ..models.imu import Preintegrated
from ..models.marginalization import MargPrior

_NESTED = {"table": FeatureTable, "marg_prior": MargPrior,
           "kf_preint": Preintegrated}


def _t(a, device):
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _n(t):
    return None if t is None else t.detach().cpu().numpy()


def _fields(cls, src, fn):
    return cls(**{f: fn(getattr(src, f, None)) for f in cls._fields})


def rig_from_numpy(rig, device="cuda") -> CameraRig:
    return _fields(CameraRig, rig, lambda a: _t(a, device))


def _state_from_numpy(cls, state, device):
    def conv(name, v):
        if name in _NESTED:
            return _fields(_NESTED[name], v, lambda a: _t(a, device))
        if name in ("pyr0", "pyr1"):
            return tuple(_t(lvl, device) for lvl in v)
        return _t(v, device)
    return cls(**{f: conv(f, getattr(state, f, None)) for f in cls._fields})


def _state_to_numpy(cls, state):
    def conv(name, v):
        if name in _NESTED:
            return type(v)(*(_n(x) for x in v))
        if name in ("pyr0", "pyr1"):
            return tuple(_n(lvl) for lvl in v)
        return _n(v)
    return cls(**{f: conv(f, getattr(state, f)) for f in cls._fields})


def state_from_numpy(state, device="cuda") -> EstimatorState:
    """JAX EstimatorState with numpy leaves -> the port's EstimatorState on
    `device`."""
    return _state_from_numpy(EstimatorState, state, device)


def state_to_numpy(state: EstimatorState) -> EstimatorState:
    """The port's EstimatorState with every tensor turned into a numpy
    array (same structure and field names as the JAX state)."""
    return _state_to_numpy(EstimatorState, state)


def vio_state_from_numpy(state, device="cuda") -> VIOEstimatorState:
    """JAX VIOEstimatorState with numpy leaves -> the port's
    VIOEstimatorState on `device`."""
    return _state_from_numpy(VIOEstimatorState, state, device)


def vio_state_to_numpy(state: VIOEstimatorState) -> VIOEstimatorState:
    """The port's VIOEstimatorState as numpy arrays (the JAX state's
    structure and field names)."""
    return _state_to_numpy(VIOEstimatorState, state)
