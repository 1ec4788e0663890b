"""The port's ``cameras.project_normalized`` and ``projection.projection_cost``
(rsvio_tpu_torch/ops) against the JAX package's (rsvio_tpu/ops), vmapped
over the same seeded numpy inputs, in float32 and in float64 (JAX under
``jax.enable_x64``).

Inputs put z below, at and above the 1e-6 cheirality threshold (and
behind the camera), and the mask at 0 and 1; the port's functions take
the batch as leading dimensions. ``projection_cost`` must also equal the
port's own ``linearize_projection(...).cost`` on the same inputs.

Tolerances: float32 1e-5 relative (the same operations in the same order;
measured 0), float64 1e-12; the validity flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvio_tpu.ops import cameras as jcam
from rsvio_tpu.ops import lie as jlie
from rsvio_tpu.ops import projection as jproj
from rsvio_tpu_torch.ops import cameras as tcam
from rsvio_tpu_torch.ops import projection as tproj

DTYPES = ("f32", "f64")
TOL = {"f32": 1e-5, "f64": 1e-12}


def _np(dt):
    return np.float32 if dt == "f32" else np.float64


EDGE_Z = (0.5e-6, 1e-6, 2e-6, 0.0, -1e-6, -2.0)
# For the cost, whose camera-frame points come out of a pose round trip
# (rounding of ~1e-7 in float32), none sits at the threshold itself.
COST_Z = (0.0, 3e-6, -0.5, -1e-6, -2.0, 5e-6)
COST_BEHIND = np.array([True, False, True, True, True, False])


def _points(rng, dt, edge_z=EDGE_Z):
    """Camera-frame points: 16 generic in front, then one at each z of
    edge_z (by default just below / at / above 1e-6, z = 0, behind the
    camera)."""
    front = np.concatenate([rng.normal(size=(16, 2)),
                            rng.uniform(0.5, 8.0, size=(16, 1))], axis=1)
    edge = np.array([[0.3, -0.2, z] for z in edge_z])
    return np.concatenate([front, edge]).astype(_np(dt))


def _close(a, b, dt):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("dt", DTYPES)
def test_project_normalized_matches_jax(dt):
    p = _points(np.random.default_rng(0), dt)
    with jax.enable_x64(dt == "f64"):
        jxy, jvalid = jax.vmap(jcam.project_normalized)(jnp.asarray(p))
        jxy, jvalid = np.asarray(jxy), np.asarray(jvalid)
    txy, tvalid = tcam.project_normalized(torch.from_numpy(p))
    assert txy.dtype == torch.from_numpy(p).dtype and txy.shape == (len(p), 2)
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    # Below 1e-6 (and at it) invalid, above valid.
    assert list(tvalid.numpy()[-6:]) == [False, False, True, False, False,
                                         False]
    _close(txy.numpy(), jxy, dt)
    # Leading batch dims: a (2, n/2, 3) batch gives the same rows.
    txy2, tvalid2 = tcam.project_normalized(
        torch.from_numpy(p).reshape(2, -1, 3))
    np.testing.assert_array_equal(txy2.reshape(-1, 2).numpy(), txy.numpy())
    np.testing.assert_array_equal(tvalid2.reshape(-1).numpy(),
                                  tvalid.numpy())


def _cost_inputs(rng, dt):
    """(T_C_B (n,4,4), T_B_W (n,4,4), p_W (n,3), obs (n,2), mask (n,)):
    poses with p_C spanning the cheirality cases of _points, the
    observations near and far from the projection (inside and beyond the
    Huber threshold), mask 0 and 1."""
    n = 22
    T_C_B = np.tile(np.eye(4), (n, 1, 1))
    T_C_B[:, :3, 3] = rng.normal(size=(n, 3)) * 0.05
    with jax.enable_x64(True):
        R = np.asarray(jax.vmap(jlie.so3_exp)(
            jnp.asarray(rng.normal(size=(n, 3)) * 0.2)))
    T_B_W = np.tile(np.eye(4), (n, 1, 1))
    T_B_W[:, :3, :3] = R
    T_B_W[:, :3, 3] = rng.normal(size=(n, 3)) * 0.3
    # Landmarks placed at chosen camera-frame points.
    p_C = _points(rng, "f64", COST_Z)
    p_B = np.einsum("nji,nj->ni", T_C_B[:, :3, :3], p_C - T_C_B[:, :3, 3])
    p_W = np.einsum("nji,nj->ni", R, p_B - T_B_W[:, :3, 3])
    xy = p_C[:, :2] / np.where(p_C[:, 2:] > 1e-6, p_C[:, 2:], 1.0)
    obs = xy + rng.normal(size=(n, 2)) * np.where(
        np.arange(n) % 3 == 0, 5.0, 0.01)[:, None]
    mask = (np.arange(n) % 4) != 1
    f = _np(dt)
    return (T_C_B.astype(f), T_B_W.astype(f), p_W.astype(f), obs.astype(f),
            mask)


@pytest.mark.parametrize("dt", DTYPES)
def test_projection_cost_matches_jax_and_linearize(dt):
    args = _cost_inputs(np.random.default_rng(1), dt)
    with jax.enable_x64(dt == "f64"):
        jc = np.asarray(jax.vmap(jproj.projection_cost)(
            *(jnp.asarray(a) for a in args)))
        jl = np.asarray(jax.vmap(jproj.linearize_projection)(
            *(jnp.asarray(a) for a in args)).cost)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    tc = tproj.projection_cost(*targs)
    assert tc.shape == (len(args[4]),)
    assert tc.dtype == targs[0].dtype
    _close(tc.numpy(), jc, dt)
    np.testing.assert_array_equal(tc.numpy(),
                                  tproj.linearize_projection(*targs)
                                  .cost.numpy())
    _close(jl, jc, dt)
    # Mask 0 costs 0; behind-camera observations cost the cheirality
    # residual's Huber value; the far observations are beyond delta.
    assert (tc.numpy()[~args[4]] == 0).all()
    r = np.hypot(tproj.CHEIRALITY_RESIDUAL, tproj.CHEIRALITY_RESIDUAL)
    behind = np.flatnonzero(args[4][16:] & COST_BEHIND)
    np.testing.assert_allclose(tc.numpy()[16:][behind], 2.0 * (r - 1.0),
                               rtol=1e-6)


@pytest.mark.parametrize("dt", DTYPES)
def test_projection_cost_broadcasts_over_leading_dims(dt):
    """A (W, 2, L) observation tensor against per-window poses and
    per-camera extrinsics, as the solvers broadcast: each element equals
    the JAX function on that element, and the delta argument is honoured."""
    rng = np.random.default_rng(2)
    T_C_B, T_B_W, p_W, obs, mask = _cost_inputs(rng, dt)
    W_, L = 3, 5
    TCB = T_C_B[:2][None, :, None]                  # (1,2,1,4,4)
    TBW = T_B_W[:W_][:, None, None]                 # (3,1,1,4,4)
    P = p_W[:L][None, None]                         # (1,1,5,3)
    O = (rng.normal(size=(W_, 2, L, 2)) * 0.5).astype(obs.dtype)
    M = np.resize(mask, (W_, 2, L))
    tc = tproj.projection_cost(*(torch.from_numpy(np.asarray(a))
                                 for a in (TCB, TBW, P, O, M)),
                               huber_delta=0.5)
    assert tc.shape == (W_, 2, L)
    with jax.enable_x64(dt == "f64"):
        for w in range(W_):
            for c in range(2):
                for l in range(L):
                    jc = float(jproj.projection_cost(
                        jnp.asarray(T_C_B[c]), jnp.asarray(T_B_W[w]),
                        jnp.asarray(p_W[l]), jnp.asarray(O[w, c, l]),
                        jnp.asarray(M[w, c, l]), huber_delta=0.5))
                    _close(tc[w, c, l].item(), jc, dt)
