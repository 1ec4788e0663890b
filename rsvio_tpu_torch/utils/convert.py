"""Carry the JAX package's rig and estimator state across to the port.

This system's counterpart of carrying weights across: a test can start both
steps from the same mid-sequence state. The inputs are the JAX package's
``CameraRig`` / ``EstimatorState`` with numpy leaves (for example
``jax.tree_util.tree_map(np.asarray, state)``); any object with the same
field names works. Every field is carried by name, so the optional state
(the RANSAC gate's ``lm_birth`` and ``health_ema``), the table's weights
``w`` and ages, and an EUCM rig's parameters come across as they are; a
field the JAX state leaves None stays None. Nothing here imports JAX or
rsvio_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.estimator import CameraRig, EstimatorState
from ..models.frontend import FeatureTable
from ..models.marginalization import MargPrior


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


def state_from_numpy(state, device="cuda") -> EstimatorState:
    """JAX EstimatorState with numpy leaves -> the port's EstimatorState on
    `device`."""
    def conv(name, v):
        if name == "table":
            return _fields(FeatureTable, v, lambda a: _t(a, device))
        if name == "marg_prior":
            return _fields(MargPrior, v, lambda a: _t(a, device))
        if name in ("pyr0", "pyr1"):
            return tuple(_t(lvl, device) for lvl in v)
        return _t(v, device)
    return EstimatorState(**{f: conv(f, getattr(state, f, None))
                             for f in EstimatorState._fields})


def state_to_numpy(state: EstimatorState) -> EstimatorState:
    """The port's EstimatorState with every tensor turned into a numpy
    array (same structure and field names as the JAX state)."""
    def conv(name, v):
        if name in ("table", "marg_prior"):
            return type(v)(*(_n(x) for x in v))
        if name in ("pyr0", "pyr1"):
            return tuple(_n(lvl) for lvl in v)
        return _n(v)
    return EstimatorState(**{f: conv(f, getattr(state, f))
                             for f in EstimatorState._fields})
