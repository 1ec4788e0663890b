"""The window solve's visual assembly: the hand-written Hopper kernel
(K3, ``csrc/ba_assemble.cu``), its wrapper and its plain PyTorch version.

One call turns the window's poses, landmarks and masked stereo
observations into one Levenberg-Marquardt system's visual blocks: the
linearization of every (window, camera, landmark) observation with the
Huber weights and the optional per-observation sqrt-weights, and the
normal-equation blocks H_pp, g_p, H_ll, H_pl, g_l with the cost sum. With
a chi^2 gate it also returns the same blocks for the gated mask
``m = mask & (r_sq <= gate^2) & act``, where ``act`` is
``stereo_observability_mask(m, lm_valid)``, with m, act and their counts:
the solvers keep one of the two systems, so one pass serves both.

The pose blocks and the cost are this shard's partial sums, as
``build_normal_equations`` gives them: the solvers' ``reduce`` hook sums
them over landmark shards.

Routing: a CUDA tensor always goes to the kernel, a CPU tensor to the plain
version (``ba_assemble_reference``). There is no fallback between them.
The kernel takes at most ``MAX_WINDOW`` keyframes (a warp's lanes hold a
landmark's 2 W observations) and raises above it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..projection import CHEIRALITY_RESIDUAL, linearize_projection
from .build import KernelError
from .klt_kernel import _route

MAX_WINDOW = 16
POSE_NUMBERS = 28   # a block's partial per pose: H_pp's upper triangle, g_p, cost


class Blocks(NamedTuple):
    """One system's visual blocks; H_pp, g_p and cost are this landmark
    shard's partial sums."""
    H_pp: torch.Tensor   # (W,6,6)
    H_ll: torch.Tensor   # (L,3,3)
    H_pl: torch.Tensor   # (W,L,6,3)
    g_p: torch.Tensor    # (W,6)
    g_l: torch.Tensor    # (L,3)
    cost: torch.Tensor   # ()


class Assembly(NamedTuple):
    """``ba_assemble``'s result. The gated fields are None without a
    gate."""
    blocks: Blocks                 # over `mask`
    r_sq: torch.Tensor             # (W,2,L) squared whitened residuals
    gated: Optional[Blocks]        # over `gate_mask`
    gate_mask: Optional[torch.Tensor]    # (W,2,L) bool
    gate_active: Optional[torch.Tensor]  # (L,) bool
    n_obs: Optional[torch.Tensor]        # () int64, gate_mask.sum()
    n_active: Optional[torch.Tensor]     # () int64, gate_active.sum()


# ---------------------------------------------------------------------------
# The plain composition (the CPU route and the kernel's reference).
# ---------------------------------------------------------------------------

def apply_obs_weights(lin, w):
    """Scale a (W,2,L) Linearization by per-slot sqrt-weights w (W,L): the
    whitened residual and Jacobians by w, the robust cost by w^2 (the Huber
    threshold still applies to the unweighted residual)."""
    sw = w[:, None, :, None]                    # (W,1,L,1)
    return lin._replace(
        r=lin.r * sw,
        J_pose=lin.J_pose * sw[..., None],
        J_lm=lin.J_lm * sw[..., None],
        cost=lin.cost * (w[:, None, :] ** 2))


def stereo_observability_mask(obs_mask, lm_valid):
    """Valid slot AND seen at least once in BOTH cameras across the
    window. obs_mask (W,2,L), lm_valid (L,) -> (L,)."""
    return (lm_valid & obs_mask[:, 0, :].any(dim=0)
            & obs_mask[:, 1, :].any(dim=0))


def linearize_window(T_B_W, T_C_B, landmarks, obs, mask, delta):
    """Linearization over (W, 2, L): T_B_W (W,4,4), T_C_B (2,4,4),
    landmarks (L,3)."""
    return linearize_projection(T_C_B[None, :, None], T_B_W[:, None, None],
                                landmarks[None, None], obs, mask, delta)


def build_normal_equations(lin):
    """Block normal equations from a (W,2,L) Linearization: H_pp (W,6,6),
    H_ll (L,3,3), H_pl (W,L,6,3), g_p (W,6), g_l (L,3)."""
    Jp, Jl, r = lin.J_pose, lin.J_lm, lin.r
    H_pp = torch.einsum("wclri,wclrj->wij", Jp, Jp)
    H_ll = torch.einsum("wclri,wclrj->lij", Jl, Jl)
    H_pl = torch.einsum("wclri,wclrj->wlij", Jp, Jl)
    g_p = torch.einsum("wclri,wclr->wi", Jp, r)
    g_l = torch.einsum("wclri,wclr->li", Jl, r)
    return H_pp, H_ll, H_pl, g_p, g_l


def _system(T_B_W, T_C_B, landmarks, obs, mask, obs_weight, huber_delta):
    lin = linearize_window(T_B_W, T_C_B, landmarks, obs, mask, huber_delta)
    if obs_weight is not None:
        lin = apply_obs_weights(lin, obs_weight)
    H_pp, H_ll, H_pl, g_p, g_l = build_normal_equations(lin)
    return (Blocks(H_pp, H_ll, H_pl, g_p, g_l, lin.cost.sum()),
            (lin.r ** 2).sum(-1))


def ba_assemble_reference(T_B_W, T_C_B, landmarks, obs, mask, obs_weight,
                          lm_valid, huber_delta: float,
                          chi2_gate: float = 0.0) -> Assembly:
    """``ba_assemble`` in plain PyTorch: the solvers' composition of
    ``linearize_window``, ``apply_obs_weights`` and
    ``build_normal_equations``, the gated system linearized again at the
    gated mask."""
    blocks, r_sq = _system(T_B_W, T_C_B, landmarks, obs, mask, obs_weight,
                           huber_delta)
    if chi2_gate <= 0.0:
        return Assembly(blocks, r_sq, None, None, None, None, None)
    m = mask & (r_sq <= chi2_gate ** 2)
    act = stereo_observability_mask(m, lm_valid)
    m = m & act[None, None, :]
    gated, _ = _system(T_B_W, T_C_B, landmarks, obs, m, obs_weight,
                       huber_delta)
    return Assembly(blocks, r_sq, gated, m, act, m.sum(), act.sum())


# ---------------------------------------------------------------------------
# The kernel.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    """The port's CUDA library (built at first use, with the KLT kernels:
    klt_kernel.load_library), with the assembly's entry points bound."""
    from .klt_kernel import load_library

    built = load_library()
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn = built.lib.ba_assemble_launch
    fn.argtypes = [i, p, p, p, p, p, p, p, i, i, d, d, d, i,
                   ctypes.POINTER(ctypes.c_void_p), p]
    fn.restype = ctypes.c_int
    built.lib.ba_assemble_blocks.argtypes = [i]
    built.lib.ba_assemble_blocks.restype = ctypes.c_int
    return built.lib


def ba_assemble(T_B_W, T_C_B, landmarks, obs, mask, obs_weight, lm_valid,
                huber_delta: float, chi2_gate: float = 0.0) -> Assembly:
    """One LM system's visual blocks, and with ``chi2_gate > 0`` those of
    its gated subset, in one pass (module docstring).

    T_B_W (W,4,4) the solver's body-from-world poses, T_C_B (2,4,4),
    landmarks (L,3), obs (W,2,L,2), mask (W,2,L) bool, obs_weight (W,L)
    sqrt-weights or None, lm_valid (L,) bool; every float tensor in one
    dtype (float32 or float64), on one device. Nothing is cast: the kernel
    is a template on the dtype. On CUDA the kernel (two launches: the
    blocks, then the pose sums in a fixed order; ``ba_assemble.launches``
    counts calls) runs for W <= MAX_WINDOW and raises above it.
    """
    W, L = T_B_W.shape[0], landmarks.shape[0]
    dtype, dev = T_B_W.dtype, T_B_W.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"T_B_W: float32 or float64, got {dtype}")
    for name, t, dt, shape in (
            ("T_C_B", T_C_B, dtype, (2, 4, 4)),
            ("T_B_W", T_B_W, dtype, (W, 4, 4)),
            ("landmarks", landmarks, dtype, (L, 3)),
            ("obs", obs, dtype, (W, 2, L, 2)),
            ("mask", mask, torch.bool, (W, 2, L)),
            ("lm_valid", lm_valid, torch.bool, (L,)),
            ("obs_weight", obs_weight, dtype, (W, L))):
        if t is None:
            continue
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, T_B_W on {dev}")
    if not _route(dev):
        return ba_assemble_reference(T_B_W, T_C_B, landmarks, obs, mask,
                                     obs_weight, lm_valid, huber_delta,
                                     chi2_gate)
    if W > MAX_WINDOW:
        raise ValueError(f"ba_assemble: the kernel takes W <= {MAX_WINDOW} "
                         f"keyframes, got {W}")
    lib = _library()
    gated = chi2_gate > 0.0
    T_B_W, T_C_B, landmarks, obs, mask, lm_valid = (
        t.contiguous() for t in (T_B_W, T_C_B, landmarks, obs, mask,
                                 lm_valid))
    if obs_weight is not None:
        obs_weight = obs_weight.contiguous()

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)

    def blocks():
        return Blocks(empty(W, 6, 6), empty(L, 3, 3), empty(W, L, 6, 3),
                      empty(W, 6), empty(L, 3), empty())

    sets = [blocks(), blocks() if gated else None]
    r_sq = empty(W, 2, L)
    m = empty(W, 2, L, dt=torch.bool) if gated else None
    act = empty(L, dt=torch.bool) if gated else None
    counts = empty(2, dt=torch.int64) if gated else None
    nblk = lib.ba_assemble_blocks(L)
    partial = empty(nblk, 2 if gated else 1, W, POSE_NUMBERS)
    count_partial = empty(nblk, 2, dt=torch.int64) if gated else None
    ptrs = []
    for b in sets:
        ptrs += ([b.H_pp, b.g_p, b.H_ll, b.g_l, b.H_pl, b.cost] if b
                 else [None] * 6)
    ptrs += [r_sq, m, act, counts, partial, count_partial]
    out = (ctypes.c_void_p * len(ptrs))(
        *[t.data_ptr() if t is not None else None for t in ptrs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ba_assemble_launch(
        int(dtype == torch.float64), T_B_W.data_ptr(), T_C_B.data_ptr(),
        landmarks.data_ptr(), obs.data_ptr(), mask.data_ptr(),
        obs_weight.data_ptr() if obs_weight is not None else None,
        lm_valid.data_ptr(), W, L, float(huber_delta),
        float(chi2_gate) ** 2, float(CHEIRALITY_RESIDUAL), int(gated), out,
        stream)
    if rc != 0:
        raise KernelError(f"ba_assemble launch failed with code {rc}")
    ba_assemble.launches += 1
    if not gated:
        return Assembly(sets[0], r_sq, None, None, None, None, None)
    return Assembly(sets[0], r_sq, sets[1], m, act, counts[0], counts[1])


# Calls of ba_assemble that launched the kernel (never the plain version).
ba_assemble.launches = 0
