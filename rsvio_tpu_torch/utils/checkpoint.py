"""Estimator state snapshots: save / restore the whole state to disk.

The file format is the JAX package's (rsvio_tpu/utils/checkpoint.py): an
``.npz`` of the state's leaves as ``leaf_<i>``, written atomically (temp
file and ``os.replace``). The leaves come in the field order of the
state's NamedTuples, depth first, tuples in order and None fields skipped,
which is the order ``jax.tree.flatten`` gives the JAX state (whose field
names ``tests/test_torch_estimator.py`` holds equal to the port's). The
port adds ``__fields__``, the dotted field names of the leaves, where JAX
writes its treedef string.

``load_state`` reads files of both packages. A port file must name the
template's fields; a JAX file (no ``__fields__``) must have the template's
number of leaves. Every leaf must have the template's shape and dtype. Any
mismatch raises ValueError (a config mismatch), as in JAX. This is how a
run's state crosses from the JAX package to the port.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def flatten(state, prefix: str = ""):
    """[(dotted name, tensor)] of a state's leaves in the JAX leaf order."""
    out = []
    if state is None:
        return out
    if torch.is_tensor(state):
        return [(prefix, state)]
    if hasattr(state, "_fields"):
        items = zip(state._fields, state)
    elif isinstance(state, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(state))
    else:
        raise TypeError(f"{prefix or 'state'}: cannot checkpoint a "
                        f"{type(state).__name__}")
    for name, v in items:
        out += flatten(v, f"{prefix}.{name}" if prefix else name)
    return out


def unflatten(template, leaves):
    """`template` with its leaves replaced, in order, from `leaves`."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if torch.is_tensor(t):
            return next(it)
        if hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        return type(t)(build(v) for v in t)

    return build(template)


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def save_state(path: str, state) -> None:
    """Write `state` (NamedTuples of tensors) to exactly `path`,
    atomically, so a crash during a periodic checkpoint never corrupts the
    previous snapshot."""
    leaves = flatten(state)
    arrays = {f"leaf_{i}": t.detach().cpu().numpy()
              for i, (_, t) in enumerate(leaves)}
    arrays["__fields__"] = _json_bytes([n for n, _ in leaves])
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_state(path: str, template, device=None):
    """Restore a state saved by this module's or the JAX package's
    save_state into the structure of `template` (a fresh state of the same
    configuration), on `device` (default: the template's)."""
    leaves_t = flatten(template)
    with np.load(path) as data:
        n_stored = sum(1 for k in data.files if k.startswith("leaf_"))
        if "__fields__" in data.files:
            names = json.loads(bytes(data["__fields__"]).decode())
            want = [n for n, _ in leaves_t]
            if names != want:
                raise ValueError(
                    f"checkpoint fields differ from the template — config "
                    f"mismatch: {sorted(set(names) ^ set(want))}")
        elif n_stored != len(leaves_t):
            raise ValueError(
                f"checkpoint has {n_stored} leaves, the template "
                f"{len(leaves_t)} — config mismatch")
        leaves = []
        for i, (name, t) in enumerate(leaves_t):
            arr = data[f"leaf_{i}"]
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            if tuple(arr.shape) != tuple(t.shape) or dtype != t.dtype:
                raise ValueError(
                    f"checkpoint leaf {i} ({name}) is {arr.dtype} "
                    f"{arr.shape}, the template {t.dtype} "
                    f"{tuple(t.shape)} — config mismatch")
            leaves.append(torch.from_numpy(arr).to(
                t.device if device is None else device))
    return unflatten(template, leaves)
