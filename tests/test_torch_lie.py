"""The port's Lie-group functions (rsvio_tpu_torch/ops/lie.py) against the
JAX package's (rsvio_tpu/ops/lie.py) on the same seeded numpy inputs.

The JAX functions take one element and are vmapped here; the port's take
the batch directly. Every case runs in float32 and in float64 (JAX under
``jax.enable_x64``). Inputs cover the small-angle Taylor branches (angles
of 1e-6 and below), generic angles, and rotations near pi about each axis,
which put ``rot_to_quat`` in each of its four Shepperd regimes (the trace,
and the largest of the three diagonal entries; as tests/test_lie.py:75).

Tolerances (absolute, elementwise): float32 1e-5, float64 1e-12 (the
functions differ from JAX's only in the order of a few operations; the
largest gaps measured are 4.8e-7 in float32 and 4.4e-16 in float64).
Round trips in the port alone (rot -> quat -> rot, T -> packed -> T,
se2 exp -> log) are held to 1e-4 / 1e-9 and se3 log -> exp to 2e-4 /
2e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.ops import lie as jlie
from rsvio_tpu_torch.ops import lie as tlie

DTYPES = ("f32", "f64")
TOL = {"f32": 1e-5, "f64": 1e-12}
RT_TOL = {"f32": 1e-5, "f64": 1e-10}
N = 24


def _np_dtype(dt):
    return np.float32 if dt == "f32" else np.float64


def _torch(x, dt):
    return torch.from_numpy(np.asarray(x, _np_dtype(dt)))


def _rotvecs(rng):
    """Axis-angles: generic, small (Taylor), zero, near pi about x, y, z
    (each Shepperd regime), and a batch at random scales."""
    generic = rng.normal(size=(N, 3)) * 0.8
    small = rng.normal(size=(4, 3)) * 1e-6
    zero = np.zeros((1, 3))
    near_pi = np.concatenate([np.eye(3) * 3.1, -np.eye(3) * 3.05])
    scales = rng.normal(size=(8, 3)) * np.logspace(-5, 0.4, 8)[:, None]
    return np.concatenate([generic, small, zero, near_pi, scales])


def _rotations(rng, dt):
    """Rotation matrices from _rotvecs, computed in float64."""
    with jax.enable_x64(True):
        R = jax.vmap(jlie.so3_exp)(jnp.asarray(_rotvecs(rng)))
        return np.asarray(R).astype(_np_dtype(dt))


def _poses(rng, dt):
    R = _rotations(rng, "f64")
    T = np.tile(np.eye(4), (len(R), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(len(R), 3)) * 2.0
    return T.astype(_np_dtype(dt))


def _quats(rng, dt):
    q = rng.normal(size=(N, 4))
    q[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, -1]]
    return q.astype(_np_dtype(dt))


def _jax(fn, dt, *args):
    with jax.enable_x64(dt == "f64"):
        return np.asarray(jax.vmap(fn)(*(jnp.asarray(a) for a in args)))


def _close(t, j, dt):
    t = t.numpy()
    assert t.dtype == _np_dtype(dt)
    np.testing.assert_allclose(t, j, atol=TOL[dt], rtol=0)


@pytest.mark.parametrize("dt", DTYPES)
def test_quat_normalize_and_mul(dt):
    rng = np.random.default_rng(1)
    a, b = _quats(rng, dt), _quats(rng, dt)
    a[5] = 0.0   # the norm's floor
    _close(tlie.quat_normalize(_torch(a, dt)),
           _jax(jlie.quat_normalize, dt, a), dt)
    _close(tlie.quat_mul(_torch(a, dt), _torch(b, dt)),
           _jax(jlie.quat_mul, dt, a, b), dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_quat_to_rot(dt):
    rng = np.random.default_rng(2)
    q = _quats(rng, dt)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _close(tlie.quat_to_rot(_torch(q, dt)), _jax(jlie.quat_to_rot, dt, q),
           dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_rot_to_quat_every_shepperd_regime(dt):
    rng = np.random.default_rng(3)
    R = _rotations(rng, dt)
    m = R.astype(np.float64)
    tr = np.trace(m, axis1=1, axis2=2)
    regime = np.where(tr > 0, 0, np.where(
        (m[:, 0, 0] > m[:, 1, 1]) & (m[:, 0, 0] > m[:, 2, 2]), 1,
        np.where(m[:, 1, 1] > m[:, 2, 2], 2, 3)))
    assert set(regime.tolist()) == {0, 1, 2, 3}
    q = tlie.rot_to_quat(_torch(R, dt))
    _close(q, _jax(jlie.rot_to_quat, dt, R), dt)
    assert bool((q[:, 0] >= 0).all())
    np.testing.assert_allclose(tlie.quat_to_rot(q).numpy(), R,
                               atol=RT_TOL[dt] * 10)


@pytest.mark.parametrize("dt", DTYPES)
def test_so3_vee_inverts_hat(dt):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(N, 3)).astype(_np_dtype(dt))
    W = tlie.so3_hat(_torch(w, dt))
    _close(tlie.so3_vee(W), _jax(jlie.so3_vee, dt, W.numpy()), dt)
    np.testing.assert_array_equal(tlie.so3_vee(W).numpy(), w)


@pytest.mark.parametrize("dt", DTYPES)
def test_se3_log_taylor_and_generic(dt):
    rng = np.random.default_rng(5)
    xi = np.concatenate([rng.normal(size=(len(_rotvecs(rng)), 3)),
                         _rotvecs(np.random.default_rng(6))], axis=1)
    xi = xi[np.linalg.norm(xi[:, 3:], axis=1) < 3.0]   # log's unique range
    with jax.enable_x64(True):
        T = np.asarray(jax.vmap(jlie.se3_exp)(jnp.asarray(xi)))
    T = T.astype(_np_dtype(dt))
    _close(tlie.se3_log(_torch(T, dt)), _jax(jlie.se3_log, dt, T), dt)
    back = tlie.se3_exp(tlie.se3_log(_torch(T, dt))).numpy()
    np.testing.assert_allclose(back, T, atol=RT_TOL[dt] * 20)


@pytest.mark.parametrize("dt", DTYPES)
def test_se3_mul_and_apply(dt):
    rng = np.random.default_rng(7)
    Ta, Tb = _poses(rng, dt), _poses(rng, dt)
    p = rng.normal(size=(len(Ta), 3)).astype(_np_dtype(dt))
    _close(tlie.se3_mul(_torch(Ta, dt), _torch(Tb, dt)),
           _jax(jlie.se3_mul, dt, Ta, Tb), dt)
    _close(tlie.se3_apply(_torch(Ta, dt), _torch(p, dt)),
           _jax(jlie.se3_apply, dt, Ta, p), dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_se3_packed_round_trip(dt):
    rng = np.random.default_rng(8)
    T = _poses(rng, dt)
    packed = tlie.se3_to_packed(_torch(T, dt))
    _close(packed, _jax(jlie.se3_to_packed, dt, T), dt)
    p7 = packed.numpy().copy()
    p7[:, 3:] *= 1.7   # from_packed normalizes the quaternion
    _close(tlie.se3_from_packed(_torch(p7, dt)),
           _jax(jlie.se3_from_packed, dt, p7), dt)
    np.testing.assert_allclose(tlie.se3_from_packed(packed).numpy(), T,
                               atol=RT_TOL[dt] * 10)


@pytest.mark.parametrize("dt", DTYPES)
def test_se2_log_taylor_and_generic(dt):
    rng = np.random.default_rng(9)
    theta = np.concatenate([rng.uniform(-3.0, 3.0, N),
                            [0.0, 1e-9, -3e-5, 5e-5, 2e-4]])
    xi = np.stack([rng.normal(size=len(theta)) * 3.0,
                   rng.normal(size=len(theta)) * 3.0, theta], axis=1)
    with jax.enable_x64(True):
        M = np.asarray(jax.vmap(jlie.se2_exp)(jnp.asarray(xi)))
    M = M.astype(_np_dtype(dt))
    _close(tlie.se2_log(_torch(M, dt)), _jax(jlie.se2_log, dt, M), dt)
    np.testing.assert_allclose(tlie.se2_log(tlie.se2_exp(
        _torch(xi, dt))).numpy(), xi, atol=RT_TOL[dt] * 10)
