"""ops.cuda.ba_kernel on the CPU: the plain version of the window solve's
visual assembly (``ba_assemble_reference``, the route a CPU tensor takes)
against the composition the solvers ran before it, bit for bit, in float32
and float64, with and without per-observation weights and the chi^2 gate;
the wrapper's checks; and the solvers' gate branch where its guard fails.

The composition is written out here as the solvers had it:
``linearize_projection`` over (W, 2, L), the sqrt-weights, the einsum
blocks, and for the gated system either a second linearization at the
gated mask (``solve_ba``, ``solve_ba_marginalized``) or the first one
multiplied by it (the VIO solve). The window holds points behind the
camera, masked slots, an invalid slot, observations the gate strips and a
landmark the gate strips of one camera. The kernel itself is held to this
plain version on the card (tests/test_torch_gpu.py).
"""

import pytest
import torch

from rsvio_tpu_torch.models import ba as ba_mod
from rsvio_tpu_torch.ops.cuda import ba_kernel
from rsvio_tpu_torch.ops.projection import linearize_projection
from rsvio_tpu_torch.parallel import dryrun

GATE = 0.02
DELTA = 0.05


def _window(dtype, W=10, L=40, seed=3):
    """dryrun's stereo window at the solvers' inputs, with the edge cases
    of the module docstring; T_B_W is the solver's variable."""
    from rsvio_tpu_torch.ops import lie

    T_W_B, T_C_B, lms, obs, mask, valid = dryrun.window_problem(
        W, L, seed=seed, device="cpu", dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    lms, obs, mask, valid = lms.clone(), obs.clone(), mask.clone(), \
        valid.clone()
    lms[0] = torch.tensor([0.3, -0.2, -2.0], dtype=dtype)   # behind
    mask[:, :, 0] = True
    valid[1] = False                                        # invalid slot
    mask &= torch.rand(mask.shape, generator=gen) > 0.1     # masked slots
    obs[:, 1, 2] += 0.1          # landmark 2 stripped of its right camera
    mask[:, :, 2] = True
    obs[3, 0, 5:9] -= 0.08       # single outliers
    obs[6, 1, 11] += 0.2
    weight = (0.5 + torch.rand((W, L), generator=gen,
                               dtype=torch.float64)).to(dtype)
    return lie.se3_inverse(T_W_B), T_C_B, lms, obs, mask, valid, weight


def _composition(T_B_W, T_C_B, lms, obs, mask, valid, w, gate, remask):
    """The solvers' former composition: (H_pp, H_ll, H_pl, g_p, g_l,
    cost), r_sq, and with a gate the gated blocks, m and act."""
    def lin_at(mk):
        lin = linearize_projection(T_C_B[None, :, None],
                                   T_B_W[:, None, None], lms[None, None],
                                   obs, mk, DELTA)
        if w is not None:
            sw = w[:, None, :, None]
            lin = lin._replace(r=lin.r * sw, J_pose=lin.J_pose * sw[..., None],
                               J_lm=lin.J_lm * sw[..., None],
                               cost=lin.cost * (w[:, None, :] ** 2))
        return lin

    def blocks(lin):
        Jp, Jl, r = lin.J_pose, lin.J_lm, lin.r
        return (torch.einsum("wclri,wclrj->wij", Jp, Jp),
                torch.einsum("wclri,wclrj->lij", Jl, Jl),
                torch.einsum("wclri,wclrj->wlij", Jp, Jl),
                torch.einsum("wclri,wclr->wi", Jp, r),
                torch.einsum("wclri,wclr->li", Jl, r), lin.cost.sum())

    lin = lin_at(mask)
    r_sq = (lin.r ** 2).sum(-1)
    if gate <= 0.0:
        return blocks(lin), r_sq, None
    m = mask & (r_sq <= gate ** 2)
    act = valid & m[:, 0, :].any(dim=0) & m[:, 1, :].any(dim=0)
    m = m & act[None, None, :]
    if remask:
        mf = m.to(lin.r.dtype)
        lin_g = lin._replace(r=lin.r * mf[..., None],
                             J_pose=lin.J_pose * mf[..., None, None],
                             J_lm=lin.J_lm * mf[..., None, None],
                             cost=lin.cost * mf)
    else:
        lin_g = lin_at(m)
    return blocks(lin), r_sq, (blocks(lin_g), m, act)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("gate", [0.0, GATE], ids=["nogate", "gate"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_plain_version_equals_the_composition(dtype, weighted, gate):
    """ba_assemble on CPU tensors (the plain version) against the former
    composition, bit for bit: the blocks, r_sq, and with the gate the
    gated blocks against both former gated forms (linearized again at m,
    and the first linearization multiplied by m), m, act and the counts."""
    T_B_W, T_C_B, lms, obs, mask, valid, w = _window(dtype)
    w = w if weighted else None
    before = ba_kernel.ba_assemble.launches
    asm = ba_kernel.ba_assemble(T_B_W, T_C_B, lms, obs, mask, w, valid,
                                DELTA, gate)
    assert ba_kernel.ba_assemble.launches == before
    for remask in (False, True):
        ref, r_sq, g = _composition(T_B_W, T_C_B, lms, obs, mask, valid, w,
                                    gate, remask)
        for a, b in zip(asm.blocks, ref):
            _equal(a, b)
        _equal(asm.r_sq, r_sq)
        if gate <= 0.0:
            assert asm.gated is None and asm.gate_mask is None
            continue
        gref, m, act = g
        for a, b in zip(asm.gated, gref):
            _equal(a, b)
        _equal(asm.gate_mask, m)
        _equal(asm.gate_active, act)
        _equal(asm.n_obs, m.sum())
        _equal(asm.n_active, act.sum())
    if gate > 0.0:
        # The gate took: outliers and landmark 2 (right camera) stripped,
        # the invalid slot never active, the rest kept.
        assert not bool(asm.gate_active[2]) and not bool(asm.gate_active[1])
        assert not bool(asm.gate_mask[:, :, 2].any())
        assert not bool(asm.gate_mask[3, 0, 5:9].any())
        assert int(asm.n_active) > 20 and int(asm.n_obs) > 200


def test_behind_camera_costs_and_contributes_nothing_to_h():
    """A point behind every camera: the cheirality cost, zero Jacobians
    and whitened residual (so r_sq 0), as linearize_projection gives."""
    T_B_W, T_C_B, lms, obs, mask, valid, _ = _window(torch.float64)
    asm = ba_kernel.ba_assemble(T_B_W, T_C_B, lms, obs, mask, None, valid,
                                DELTA, GATE)
    assert torch.equal(asm.r_sq[:, :, 0],
                       torch.zeros_like(asm.r_sq[:, :, 0]))
    assert torch.equal(asm.blocks.H_ll[0], torch.zeros(3, 3,
                                                       dtype=torch.float64))
    assert torch.equal(asm.blocks.H_pl[:, 0],
                       torch.zeros_like(asm.blocks.H_pl[:, 0]))


@pytest.mark.parametrize("case", ["dtype", "mask_dtype", "shape", "weight",
                                  "device", "int"])
def test_wrapper_rejects_what_it_does_not_take(case):
    T_B_W, T_C_B, lms, obs, mask, valid, w = _window(torch.float32, L=16)
    args = dict(T_B_W=T_B_W, T_C_B=T_C_B, landmarks=lms, obs=obs, mask=mask,
                obs_weight=w, lm_valid=valid)
    err = ValueError
    if case == "dtype":
        args["landmarks"], err = lms.double(), TypeError
    elif case == "mask_dtype":
        args["mask"], err = mask.to(torch.uint8), TypeError
    elif case == "shape":
        args["obs"] = obs[:, :, :-1]
    elif case == "weight":
        args["obs_weight"] = w[:, :-1]
    elif case == "device":
        args = {k: v.to("meta") for k, v in args.items()}
    else:
        args["T_B_W"], err = T_B_W.to(torch.int32), TypeError
    with pytest.raises(err):
        ba_kernel.ba_assemble(huber_delta=DELTA, chi2_gate=GATE, **args)


@pytest.mark.parametrize("solver", ["solve_ba", "solve_ba_marginalized"])
def test_gate_whose_guard_fails_keeps_the_ungated_system(solver):
    """A gate so tight that the under-constraint guard fails at every
    iteration: the solve is bit for bit the solve without the gate."""
    from rsvio_tpu_torch.models import marginalization as mg

    T_W_B, T_C_B, lms, obs, mask, valid = dryrun.window_problem(
        6, 48, seed=4, device="cpu", dtype=torch.float64)
    out = []
    for gate in (0.0, 1e-9):
        cfg = ba_mod.BAConfig(chi2_gate=gate)
        if solver == "solve_ba":
            r = ba_mod.solve_ba(T_W_B, T_C_B, lms, obs, mask, valid, cfg)
            out.append((r.T_W_B, r.landmarks, r.metrics, r.final_cost))
        else:
            r, p = ba_mod.solve_ba_marginalized(
                T_W_B, T_C_B, lms, obs, mask, valid,
                mg.empty_prior(6, 6, torch.float64, "cpu"),
                torch.tensor(True), cfg)
            out.append((r.T_W_B, r.landmarks, r.metrics, p.H, p.g))
    assert bool(r.success)
    for a, b in zip(*out):
        _equal(a, b)
