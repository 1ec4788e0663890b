"""The adaptive dynamic-scene profile (config/euroc_vo_adaptive.yaml, the
benchmark's ``euroc_vo_adaptive`` configuration) against the plain
reference of its RANSAC consensus gate, portbench/reference_gate.py
(float64, one hypothesis at a time, autograd Jacobians, no import of the
program).

On the CPU, on seeded random scenes (a rigid world seen by the stereo rig,
a share of gross outliers, random track ages and masks): the port's
``ransac_pnp_gate`` and each of its hypotheses' inlier sets at L=32, K=8
and at the shipped K=16, L=256, in float64 and float32; ``run_motion``'s
health (ramp, floor, hysteresis), the motion prior's scale 1 - health and
the kill set; an exact vote tie going to the lowest index; the CPU
compiled step of the small scene, each gated frame against the reference
from the state handed to the step and its draws. Then the configuration
file against the shipped YAML, key for key, and the gate's counters and
``step.draws`` span, which exist only with the gate on, with the two
metric readers that read the counters.

Tolerances: in float64 the sets are equal but for observations
whose reference r^2 lies within 1e-9 relative of threshold^2. In float32
an observation within BAND_F32 relative of threshold^2 may fall either
way: the port solves each 4-point hypothesis in float32, whose pose
carries the solve's rounding (~1e-6 of the pose, so up to ~1e-3 of an r^2
near threshold^2 at the 5 m plane). The winner, ok and the count must
be those of the reference's winner or of a hypothesis whose vote is
within one observation's largest vote (ransac_age_cap) of the winner's (a
float32 pose can move one observation across the threshold); the count
may differ by the observations in the band; health within 1e-6 of the
reference's at the port's count (float32 rounding of a ratio of counts);
the kill set equal but for tracks with an observation in the band.

The card (``gpu``-marked; this file imports neither JAX nor rsvio_tpu):
the compiled step under the benchmark's cell ``euroc_vo_adaptive.batch``
(five streams, closed loop) against the reference on at least 200 gated
frames: the frame's outputs as above, and segment M's own per-hypothesis
inlier sets and votes, copied inside its graph, each against the
reference's (a set but for the band; a vote exactly that of the port's
own set; a hypothesis whose reference sample is within SAMPLE_GAP of
another left out). ``card_comparison(dev, tf32=True)`` makes the same
comparison with the program's float32 products in TF32 from before its
graphs are captured (a graph replays the kernels it captured) and
reports it:

    python -m pytest --noconftest tests/test_torch_adaptive_gate.py -q -s
"""

import json
import os
import tempfile
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import reference_gate as ref
from portbench import drive, spec
from rsvio_tpu_torch import profiling
from rsvio_tpu_torch.data import bench_scene
from rsvio_tpu_torch.models import estimator as est
from rsvio_tpu_torch.models import pnp as pnp_mod
from rsvio_tpu_torch.models.frontend import FrontendConfig, init_table
from rsvio_tpu_torch.ops.klt import KLTConfig
from rsvio_tpu_torch.utils.config import load_config, make_estimator_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = 0.00872          # the profile's ransac_threshold
BAND_F64 = 1e-9
BAND_F32 = 1e-3
HEALTH_TOL = 1e-6
SHAPE = (96, 128)


@pytest.fixture(autouse=True)
def fresh():
    torch.set_num_threads(2)
    profiling.clear()
    yield
    profiling.clear()


# --- seeded random scenes ----------------------------------------------------

def _rot(w):
    W = torch.tensor([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                      [-w[1], w[0], 0.0]], dtype=torch.float64)
    return torch.linalg.matrix_exp(W)


def _pose(w, t):
    T = torch.eye(4, dtype=torch.float64)
    T[:3, :3] = _rot(w)
    T[:3, 3] = torch.tensor(t, dtype=torch.float64)
    return T


def random_scene(L, K, seed, outliers=0.15, ages=25):
    """Landmarks 3-7 m ahead, seen from a true pose by a 0.11 m stereo
    pair; observations with 1e-4 noise, `outliers` of the slots moved by
    0.05-0.15 in each coordinate; 85 % of the observations valid; the
    seed pose 2 cm and 10 mrad off. Float64."""
    g = torch.Generator().manual_seed(seed)
    T_C_B = torch.stack([torch.eye(4, dtype=torch.float64)] * 2)
    T_C_B[1, 0, 3] = -0.11
    T_W_B = _pose([0.02, -0.03, 0.01], [0.3, -0.1, 0.2])
    p_B = torch.stack([(torch.rand(L, generator=g) - 0.5) * 6.0,
                       (torch.rand(L, generator=g) - 0.5) * 4.0,
                       3.0 + 4.0 * torch.rand(L, generator=g)], dim=1)
    p_B = p_B.to(torch.float64)
    lm = p_B @ T_W_B[:3, :3].T + T_W_B[:3, 3]
    obs = torch.stack([(p_B[:, :2] + T_C_B[c, :2, 3]) / p_B[:, 2:]
                       for c in range(2)])
    obs = obs + 1e-4 * torch.randn(obs.shape, generator=g,
                                   dtype=torch.float64)
    bad = torch.rand(L, generator=g) < outliers
    n_bad = (2, int(bad.sum()), 2)
    sign = torch.where(torch.rand(n_bad, generator=g) < 0.5, -1.0, 1.0)
    obs[:, bad] += sign.to(torch.float64) * (0.05 + 0.1 * torch.rand(
        n_bad, generator=g, dtype=torch.float64))
    mask = torch.rand((2, L), generator=g) < 0.85
    age = torch.randint(0, ages, (L,), generator=g, dtype=torch.int32)
    seed_pose = T_W_B @ _pose([0.01, 0.0, -0.005], [0.02, -0.01, 0.01])
    gumbel = -torch.log(torch.empty((K, 2 * L), dtype=torch.float64)
                        .exponential_(generator=g))
    return dict(T_W_B=seed_pose, T_C_B=T_C_B, lm=lm, obs=obs, mask=mask,
                age=age, gumbel=gumbel)


def pnp_cfg(K, **kw):
    return pnp_mod.PnPConfig(ransac_hypotheses=K,
                             ransac_threshold=THRESHOLD, **kw)


def params(K, **kw):
    return ref.GateParams(hypotheses=K, threshold=THRESHOLD, **kw)


def cast(sc, dtype):
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in sc.items()}


# --- the comparison, shared with the card's test -----------------------------

def band_of(r2, thr, rel):
    """Observations whose r^2 lies within `rel` of thr^2."""
    return (r2 - thr ** 2).abs() <= rel * thr ** 2


def tied(g: ref.Gate, p: ref.GateParams):
    """The hypotheses the port may have picked: the reference's winner, and
    each whose vote is within one observation's largest vote of it (a
    float32 pose moves an observation across the threshold)."""
    top = g.votes[g.best]
    return [g.best] + [k for k, v in enumerate(g.votes)
                       if k != g.best and top - v <= max(p.age_cap, 1)]


def won_by(g: ref.Gate, k: int, mask, p: ref.GateParams) -> ref.Gate:
    """The reference's outcome had hypothesis k won the vote."""
    count = int(g.inliers[k].sum())
    ok = count >= p.min_inliers and g.n_valid >= p.min_inliers
    return g._replace(best=k, best_count=count, ok=ok,
                      inlier_mask=g.inliers[k] if ok else mask)


def _mismatches(g: ref.Gate, p, mask, rel, port):
    band = band_of(g.r2[g.best], p.threshold, rel) & mask
    bad = []
    if bool(port["ok"]) != g.ok:
        bad.append(f"ok: {bool(port['ok'])} vs {g.ok}")
    n_band = int(band.sum())
    if abs(int(port["count"]) - g.best_count) > n_band:
        bad.append(f"count: {int(port['count'])} vs {g.best_count} "
                   f"(band {n_band})")
    if port.get("inliers") is not None:
        diff = (port["inliers"].cpu().bool() ^ g.inlier_mask) & ~band
        if bool(diff.any()):
            bad.append(f"inliers: {int(diff.sum())} differ outside the band")
    if port.get("kill") is not None:
        k_ref = ref.kill(g, mask, bool(port["pnp_success"]), p)
        diff = (port["kill"].cpu().bool() ^ k_ref) & ~band.any(dim=0)
        if bool(diff.any()):
            bad.append(f"kills: {int(diff.sum())} differ outside the band")
    return bad


def compare_gate(g: ref.Gate, p, mask, rel, port):
    """Mismatches of one gate call (empty when within the tolerances): the
    port's ok, count and, where given, inlier set and kill set against the
    outcome of the reference's winner, or of a hypothesis tied with it."""
    first = None
    for k in tied(g, p):
        bad = _mismatches(won_by(g, k, mask, p), p, mask, rel, port)
        if not bad:
            return []
        first = bad if first is None else first
    return first


def compare_motion(case, p: ref.GateParams, rel):
    """One gated frame of a step: the gate's ok and count, the kill set and
    the health against the reference from the frame's own inputs (the
    state handed to the step, its draws, the front end's table and
    observations of segment M). Returns (mismatches, reference gate)."""
    mask = ref.candidates(case["obs_mask"], case["lm_fid"],
                          case["table_fid"], case["alive"])
    g = ref.ransac_gate(case["T_W_B"], case["T_C_B"], case["lm_birth"],
                        case["obs"], mask, case["gumbel"], case["age"], p)
    bad = compare_gate(g, p, mask, rel, {
        "ok": case["ransac_ok"], "count": case["n_inliers"],
        "kill": case["kill"], "pnp_success": case["pnp_success"]})
    n_cand = int(mask.sum())
    if int(case["n_pnp"]) != n_cand:
        bad.append(f"candidates: {int(case['n_pnp'])} vs {n_cand}")
    # Health at the port's own count: the count is held above.
    at_port = g._replace(best_count=int(case["n_inliers"]),
                         ok=bool(case["ransac_ok"]))
    h_ref = ref.health(at_port, n_cand, p, case["health_prev"])
    if abs(float(case["health"]) - h_ref) > HEALTH_TOL:
        bad.append(f"health: {float(case['health'])} vs {h_ref}")
    return bad, g


def tap_frame(step, prev, rig):
    """Device copies of one frame's gate inputs and outputs, taken after
    the compiled step ran it (segment M's buffer holds this frame's)."""
    seg = step._mid.tree
    mo = seg.mo

    def c(t):
        return t.detach().clone()

    return {"T_W_B": c(prev.T_W_B), "lm_birth": c(prev.lm_birth),
            "lm_fid": c(prev.lm_fid), "health_prev": c(prev.health_ema),
            "T_C_B": c(rig.T_C_B), "gumbel": c(step._gumbel),
            "obs": c(seg.obs_cur), "obs_mask": c(seg.obs_cur_mask),
            "table_fid": c(seg.table.fid), "alive": c(seg.table.alive),
            "age": c(seg.table.age), "ransac_ok": c(mo.ransac_ok),
            "n_inliers": c(mo.n_inliers), "n_pnp": c(mo.n_pnp),
            "health": c(mo.health), "kill": c(mo.kill),
            "pnp_success": c(mo.pnp_success)}


def to_host(case):
    return {k: v.cpu() for k, v in case.items()}


# --- the gate alone ----------------------------------------------------------

@pytest.mark.parametrize("L,K", [(32, 8), (256, 16)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gate_matches_reference(L, K, dtype):
    """ransac_pnp_gate and every hypothesis' inlier set against the
    reference on the same (dtype-rounded) inputs."""
    rel = BAND_F64 if dtype == torch.float64 else BAND_F32
    cfg, p = pnp_cfg(K), params(K)
    for seed in (1, 2):
        sc = cast(random_scene(L, K, seed), dtype)
        args = (sc["T_W_B"], sc["T_C_B"], sc["lm"], sc["obs"], sc["mask"],
                sc["gumbel"], cfg)
        inl, ok, count = pnp_mod.ransac_pnp_gate(*args, age=sc["age"])
        hyp, _ = pnp_mod.ransac_hypotheses(*args, age=sc["age"])
        g = ref.ransac_gate(sc["T_W_B"], sc["T_C_B"], sc["lm"], sc["obs"],
                            sc["mask"], sc["gumbel"], sc["age"], p)
        assert g.ok and 0 < g.best_count < int(sc["mask"].sum())
        assert compare_gate(g, p, sc["mask"], rel, {
            "ok": ok, "count": count, "inliers": inl}) == []
        for k in range(K):
            band = band_of(g.r2[k], THRESHOLD, rel)
            assert not bool(((hyp[k] ^ g.inliers[k]) & ~band).any()), k
        if dtype == torch.float64:
            assert bool(ok) == g.ok and int(count) == g.best_count


def test_vote_tie_goes_to_lowest_index():
    """Two rigid groups of equal size and ages (the world and a mover 0.3 m
    off) tie exactly; hypothesis 0 samples the mover's group, 1 the
    world's: the mover's group wins, in the port and the reference, in
    float64 and float32."""
    L, K = 64, 4
    sc = random_scene(L, K, 3, outliers=0.0)
    half = torch.arange(L) < L // 2
    shift = _pose([0.0, 0.0, 0.0], [0.3, 0.0, 0.0])
    lm = sc["lm"]
    seen = torch.where(half[:, None], lm, lm @ shift[:3, :3].T + shift[:3, 3])
    T_B_W = torch.linalg.inv(sc["T_W_B"])
    obs = []
    for c in range(2):
        p_C = seen @ (sc["T_C_B"][c] @ T_B_W)[:3, :3].T \
            + (sc["T_C_B"][c] @ T_B_W)[:3, 3]
        obs.append(p_C[:, :2] / p_C[:, 2:])
    obs = torch.stack(obs)
    mask = torch.ones((2, L), dtype=torch.bool)
    age = torch.full((L,), 5, dtype=torch.int32)
    gumbel = torch.zeros((K, 2 * L), dtype=torch.float64)
    mover = torch.arange(L // 2, L // 2 + 4)
    world = torch.arange(0, 4)
    gumbel[0, mover] = 50.0
    for k in range(1, K):
        gumbel[k, world + 4 * k] = 50.0
    p = params(K)
    for dtype in (torch.float64, torch.float32):
        args = [t.to(dtype) for t in (sc["T_W_B"], sc["T_C_B"], lm, obs)]
        inl, ok, count = pnp_mod.ransac_pnp_gate(
            *args, mask, gumbel.to(dtype), pnp_cfg(K), age=age)
        g = ref.ransac_gate(*args, mask, gumbel.to(dtype), age, p)
        assert g.best == 0 and g.votes[0] == g.votes[1] == g.runner_up
        assert bool(ok) and int(count) == L
        assert torch.equal(inl, g.inlier_mask)
        assert bool(inl[:, L // 2:].all()) and not bool(inl[:, :L // 2].any())


# --- run_motion's health, prior scale and kill -------------------------------

def _motion_cfg(K, **kw):
    return est.EstimatorConfig(
        frontend=FrontendConfig(capacity=0),
        pnp=pnp_mod.PnPConfig(ransac_hypotheses=K,
                              ransac_threshold=THRESHOLD,
                              motion_prior_weight=20.0),
        use_obs_weights=True, pnp_prior_adaptive=True,
        vision_weight_adaptive=True, **kw)


@pytest.mark.parametrize("L,K", [(32, 8), (256, 16)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_run_motion_matches_reference(L, K, dtype, monkeypatch):
    """run_motion on a frame: ransac_ok, the count, the health (the ramp,
    and with health_recover 0.1 the hysteresis; the floor when the gate
    loses), the prior scale handed to solve_pnp, the kill set."""
    rel = BAND_F64 if dtype == torch.float64 else BAND_F32
    scales = []
    solve = pnp_mod.solve_pnp

    def spy(*a, prior_scale=None, **kw):
        scales.append(prior_scale)
        return solve(*a, prior_scale=prior_scale, **kw)

    monkeypatch.setattr(est.pnp_mod, "solve_pnp", spy)
    cases = [(4, 0.3, 1.0, {}), (5, 0.3, 0.2, dict(health_recover=0.1)),
             (6, 1.0, 1.0, {})]      # no consensus
    for seed, share, h_prev, kw in cases:
        sc = cast(random_scene(L, K, seed, outliers=share), dtype)
        cfg = _motion_cfg(K, **kw)
        p = params(K, prior_adaptive=True, **{
            "health_recover": kw.get("health_recover", 1.0)})
        table = init_table(L, dtype, "cpu")._replace(
            fid=torch.arange(L, dtype=torch.int32),
            alive=torch.ones(L, dtype=torch.bool), age=sc["age"],
            w=torch.ones(L, dtype=dtype))
        rig = est.CameraRig(None, sc["T_C_B"], None)
        prev = torch.tensor(h_prev, dtype=dtype)
        scales.clear()
        mo = est.run_motion(
            cfg, rig, table, sc["obs"], sc["mask"], sc["lm"], table.fid,
            sc["lm"], torch.tensor(3, dtype=torch.int32), sc["T_W_B"],
            T_pred=sc["T_W_B"], T_gate_seed=sc["T_W_B"], T_prior=sc["T_W_B"],
            T_fallback=sc["T_W_B"], ready=True, gumbel=sc["gumbel"],
            obs_w_slots=table.w, health_prev=prev)
        case = {"T_W_B": sc["T_W_B"], "lm_birth": sc["lm"],
                "lm_fid": table.fid, "health_prev": prev,
                "T_C_B": sc["T_C_B"], "gumbel": sc["gumbel"],
                "obs": sc["obs"], "obs_mask": sc["mask"],
                "table_fid": table.fid, "alive": table.alive,
                "age": sc["age"], "ransac_ok": mo.ransac_ok,
                "n_inliers": mo.n_inliers, "n_pnp": mo.n_pnp,
                "health": mo.health, "kill": mo.kill,
                "pnp_success": mo.pnp_success}
        bad, g = compare_motion(case, p, rel)
        assert bad == [], (seed, bad)
        h = ref.health(g, int(mo.n_pnp), p, prev)
        assert len(scales) == 1 and abs(
            float(scales[0]) - ref.prior_scale(h, p)) <= HEALTH_TOL
        if share < 0.5:
            assert g.ok and 0.0 < h < 1.0 and bool(mo.kill.any())
        else:
            assert not g.ok and h == p.health_floor
            assert not bool(mo.kill.any())
        if kw:
            assert h == pytest.approx(h_prev + 0.1)


# --- the compiled step on the CPU --------------------------------------------

@pytest.fixture(scope="module")
def small():
    tex = bench_scene.make_texture(1, size=768,
                                   octaves=((90.0, 24), (60.0, 96)))
    frames = bench_scene.stereo_frames(tex, 8, step_m=0.02, shape=SHAPE,
                                       fx=100.0, plane_z=4.0, scale=60.0,
                                       offset=200.0)
    base = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=32, cell_size=24, detect_margin=10,
                                klt=KLTConfig(levels=3, max_iterations=8)),
        window_size=4, image_shape=SHAPE)
    # The ramp between 0.9 and 1.1 and the 3e-3 threshold keep the health
    # off 1 and kill tracks on this clean scene.
    adaptive = base._replace(
        use_obs_weights=True, pnp_prior_adaptive=True,
        vision_weight_adaptive=True, health_recover=0.5, health_f_lo=0.9,
        health_f_hi=1.1,
        pnp=base.pnp._replace(ransac_hypotheses=8, ransac_threshold=3e-3,
                              motion_prior_weight=20.0))
    rig = bench_scene.make_rig("cpu", shape=SHAPE, fx=100.0)
    return base, adaptive, frames, rig


def _drive(cfg, frames, rig, tap=False):
    step = est.make_compiled_estimator_step(cfg, device="cpu")
    state = est.init_state(cfg, device="cpu")
    cases = []
    for a, b in frames:
        prev = state
        state, _ = step(state, rig, a, b)
        if tap and step.last_variants[0] == ("motion", True):
            cases.append(tap_frame(step, prev, rig))
    return step, cases


def test_compiled_step_gate_matches_reference(small):
    """Every gated frame of the CPU compiled step against the reference,
    float32 at the band; the gate's counters are the frames' sums and the
    draws are recorded as ``step.draws`` once a gated frame, inside
    ``step.load``."""
    _, cfg, frames, rig = small
    n0 = len(profiling._counters)
    with profiling.recording():
        step, cases = _drive(cfg, frames, rig, tap=True)
    p = ref.GateParams(hypotheses=8, threshold=3e-3, health_f_lo=0.9,
                       health_f_hi=1.1, health_recover=0.5,
                       prior_adaptive=True)
    assert len(cases) == len(frames) - 1
    for c in cases:
        bad, _ = compare_motion(c, p, BAND_F32)
        assert bad == [], bad
    assert len(profiling._counters) == n0 + 1
    sums = profiling.counter_sums()
    want = {"frames": len(cases),
            "won": sum(int(c["ransac_ok"]) for c in cases),
            "inliers": sum(int(c["n_inliers"]) for c in cases
                           if bool(c["ransac_ok"])),
            "candidates": sum(int(c["n_pnp"]) for c in cases
                              if bool(c["ransac_ok"])),
            "killed": sum(int(c["kill"].sum()) for c in cases)}
    assert {f: sums[f"pnp_gate.{f}"] for f in est.GATE_FIELDS} == want
    assert want["killed"] > 0 and 0 < want["inliers"] < want["candidates"]
    spans = profiling.records().spans
    draws = [s for s in spans if s.name == "step.draws"]
    loads = {s.id: s for s in spans if s.name == "step.load"}
    assert [s.attrs["frame"] for s in draws] == list(range(1, len(frames)))
    assert all(s.parent in loads for s in draws)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with _Ops() as rec:
        fn()
    return rec.names


def _parent_motion(step, ready, gate):
    """Segment M's body without the counters."""
    def fn():
        seg = step._sg.motion(step._in.tree, step._rig.tree,
                              *step._img.tree, ready,
                              step._gumbel if gate else None)
        step._keep_mid(seg, seg.mo.is_kf)
    return fn


@pytest.mark.parametrize("name", ["default", "adaptive"])
def test_counters_only_with_the_gate(small, name):
    """Without the gate the step makes no counter, records no
    ``step.draws`` and its segments M (both variants) and K run the ops of
    the segments' bodies alone; with it, segment M's gated variant adds
    exactly gate_counts and its one in-place add."""
    base, adaptive, frames, rig = small
    cfg = base if name == "default" else adaptive
    n0 = len(profiling._counters)
    with profiling.recording():
        step, _ = _drive(cfg, frames[:4], rig)
    gate = name == "adaptive"
    assert len(profiling._counters) == n0 + gate
    assert (step.gate_counts is not None) == gate
    names = [s.name for s in profiling.records().spans]
    assert ("step.draws" in names) == gate
    for ready in (False, True):
        got = _ops(step._motion(ready))
        want = _ops(_parent_motion(step, ready, ready and gate))
        if gate and ready:
            extra = _ops(lambda: step.gate_counts.add_(
                est.gate_counts(step._mid.tree.mo)))
            want = want + extra
        assert got == want, (name, ready)
    for is_kf, solve in ((False, False), (True, True)):
        def parent_opt():
            step._keep_new(step._sg.opt(step._in.tree, step._rig.tree,
                                        step._mid.tree, is_kf, solve))
        assert _ops(step._opt(is_kf, solve)) == _ops(parent_opt)


# --- the configuration and the readers ---------------------------------------

def test_config_is_the_shipped_profile():
    """configs/euroc_vo_adaptive.json's config, written as the harness
    writes it and loaded, is config/euroc_vo_adaptive.yaml: the same
    loaded Config and the same EstimatorConfig and rig; kind vo, nothing
    reduced."""
    conf = spec.config("euroc_vo_adaptive")
    assert conf["kind"] == "vo" and conf["reduced"] == []
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "config.yaml")
        drive.write_yaml(conf["config"], path)
        got = load_config(path)
    shipped = load_config(os.path.join(ROOT, "config",
                                       "euroc_vo_adaptive.yaml"))
    assert got == shipped
    (e1, r1), (e2, r2) = (make_estimator_config(c, kind="vo", device="cpu")
                          for c in (got, shipped))
    assert e1 == e2 and e1.pnp.ransac_hypotheses == 16
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))
    prog = drive.Program(conf, "cpu")
    assert prog.ecfg == e2
    p = ref.params_from_config(conf["config"])
    assert (p.hypotheses, p.threshold, p.min_inliers, p.prior_adaptive) == \
        (16, THRESHOLD, 12, True)


METRICS = ("gate_won_pct.batch", "gate_inlier_pct.batch")


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_readers_none_without_counters(monkeypatch):
    """The two readers give None on a run whose program has no gate
    counter, and on a program without ``counter_sums``."""
    from portbench.run import RunData
    for name in METRICS:
        assert _read(name, RunData()) is None
    monkeypatch.delattr(profiling, "counter_sums")
    for name in METRICS:
        assert _read(name, RunData()) is None


def test_readers_read_the_gate(small):
    from portbench.run import RunData
    _, cfg, frames, rig = small
    _drive(cfg, frames[:5], rig)
    sums = profiling.counter_sums()
    run = RunData()
    won = _read("gate_won_pct.batch", run)
    assert won == 100.0 * sums["pnp_gate.won"] / sums["pnp_gate.frames"]
    assert _read("gate_inlier_pct.batch", run) == pytest.approx(
        100.0 * sums["pnp_gate.inliers"] / sums["pnp_gate.candidates"])


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# A sample whose S-th and (S+1)-th reference scores lie this close may be
# another in the program: it adds the float32 draw and the float32 log
# weight, ~1e-6 apart from the float64 sum at the scores' size (|score| < 8).
SAMPLE_GAP = 1e-5


def sample_gaps(gumbel, mask, age, p: ref.GateParams):
    """Per hypothesis, the gap between the reference's S-th and (S+1)-th
    sampling scores (inf where fewer than S + 1 are valid)."""
    L = mask.shape[1]
    logw = torch.tensor(ref.vote_weights(age, p, L), dtype=torch.float64)
    g = gumbel.to(torch.float64) + logw.log().repeat(2)
    g = torch.where(mask.reshape(-1)[None, :], g, -torch.inf)
    top = torch.sort(g, dim=1, descending=True)[0]
    gap = top[:, p.sample - 1] - top[:, p.sample]
    return torch.where(torch.isfinite(gap), gap, torch.inf).tolist()


def compare_hypotheses(case, g: ref.Gate, p: ref.GateParams, rel):
    """Segment M's own per-hypothesis inlier sets and votes (copied inside
    its graph) against the reference's. Each vote must be the exact integer
    vote of the program's own set; each set the reference's but for the
    band (a sample within SAMPLE_GAP of another is left out); the winner
    the first maximum of the votes, and where every vote is the
    reference's, the reference's winner and count exactly. Returns
    (mismatches, hypotheses left out)."""
    inl, votes = case["hyp_inliers"].bool(), case["hyp_votes"].tolist()
    mask = ref.candidates(case["obs_mask"], case["lm_fid"],
                          case["table_fid"], case["alive"])
    bad, skipped = [], 0
    gaps = sample_gaps(case["gumbel"], mask, case["age"], p)
    for k in range(len(votes)):
        own = ref.vote(inl[k], case["age"], p)
        if votes[k] != own:
            bad.append(f"vote {k}: {votes[k]} vs {own} of its own set")
        if gaps[k] <= SAMPLE_GAP:
            skipped += 1
            continue
        diff = (inl[k] ^ g.inliers[k]) & ~band_of(g.r2[k], p.threshold, rel)
        if bool(diff.any()):
            bad.append(f"hypothesis {k}: {int(diff.sum())} inliers differ "
                       "outside the band")
    best = votes.index(max(votes))
    count = int(case["n_inliers"])
    if int(inl[best].sum()) != count:
        bad.append(f"winner: count {count} is not hypothesis {best}'s")
    if not skipped and votes == g.votes and (best, count) != (
            g.best, g.best_count):
        bad.append(f"winner: {best} ({count}) vs {g.best} ({g.best_count})")
    return bad, skipped


class _Hyps:
    """Copies of the gate's per-hypothesis inlier sets and votes: while a
    `_Tap` step runs segment M eagerly (its first use, and its capture),
    ransac_hypotheses and ransac_votes copy their results into that tap's
    buffers, so that each replay of the captured graph writes them there."""

    def __init__(self):
        self.cur = threading.local()
        self.orig = pnp_mod.ransac_hypotheses, pnp_mod.ransac_votes

    def hypotheses(self, *args, **kw):
        inl, vote_w = self.orig[0](*args, **kw)
        tap = getattr(self.cur, "tap", None)
        if tap is not None:
            if tap.inl is None:
                tap.inl = torch.empty_like(inl)
            tap.inl.copy_(inl)
        return inl, vote_w

    def votes(self, *args, **kw):
        v = self.orig[1](*args, **kw)
        tap = getattr(self.cur, "tap", None)
        if tap is not None:
            if tap.votes is None:
                tap.votes = torch.empty_like(v)
            tap.votes.copy_(v)
        return v

    def __enter__(self):
        pnp_mod.ransac_hypotheses, pnp_mod.ransac_votes = (self.hypotheses,
                                                           self.votes)
        return self

    def __exit__(self, *exc):
        pnp_mod.ransac_hypotheses, pnp_mod.ransac_votes = self.orig


class _Tap:
    """A stream's compiled step that, once `on`, keeps of its gated frames a
    `share` drawn from `rng`: their tap_frame copies with segment M's
    per-hypothesis inlier sets and votes, appended to `taps`."""

    def __init__(self, step, hyps, rng, share, taps):
        self.step, self.hyps, self.rng = step, hyps, rng
        self.share, self.taps, self.on = share, taps, False
        self.inl = self.votes = None

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, state, rig, *args):
        self.hyps.cur.tap = self
        try:
            out = self.step(state, rig, *args)
        finally:
            self.hyps.cur.tap = None
        if self.on and self.step.last_variants[0] == ("motion", True) \
                and self.rng.random() < self.share:
            case = tap_frame(self.step, state, rig)
            case["hyp_inliers"] = self.inl.clone()
            case["hyp_votes"] = self.votes.clone()
            self.taps.append(case)
        return out


def card_comparison(dev, tf32: bool, seconds=10.0, share=0.2,
                    seed=2147483901):
    """The cell euroc_vo_adaptive.batch's set-up (its configuration, the
    batch traffic's five streams, warm-up; with `tf32`, the program's
    float32 products in TF32 from before its graphs are captured), then
    `seconds` of its closed loop with a share of the gated frames tapped;
    each tapped frame against the reference: its outputs (compare_motion)
    and segment M's per-hypothesis sets and votes (compare_hypotheses).
    Returns a summary."""
    from portbench import scene

    conf = spec.config("euroc_vo_adaptive")
    traffic = spec.traffic("batch")
    cuda = dev.type == "cuda"
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    taps = []
    try:
        with _Hyps() as hyps:
            program = drive.Program(conf, dev)
            rig = scene.rig_from_config(conf["config"])
            loop = scene.loop_from_traffic(traffic)
            plane = scene.make_plane(loop, rig,
                                     float(traffic["plane_dist_m"]))
            S = int(traffic["streams"])
            rnd = scene.Renderer(rig, plane, dev)
            streams = []
            for i in range(S):
                frames = scene.render_loop(
                    rnd, loop, scene.make_texture(seed + i, dev), cuda)
                s = drive.Stream(i, scene.start_frame(i, S, loop.frames),
                                 frames, None, program, 0.0,
                                 np.random.default_rng(i))
                s.state = program.initial_state(None)
                s.step = _Tap(s.step, hyps,
                              np.random.default_rng([seed, i]), share, taps)
                streams.append(s)
            del rnd

            def need(st):
                u = st.step.graphs.uses
                return ("opt", False, False) in u and ("opt", True, True) in u

            for s in streams:
                drive.warm(s, need, program.window + 2 * loop.frames)
            for s in streams:
                s.step.on = True
            drive.run_closed(streams, seconds, threads=cuda)
            if cuda:
                torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    cases = [to_host(c) for c in taps]
    for s in streams:
        s.step = s.state = None
    p = ref.params_from_config(conf["config"])
    fails, kinds, n_tied, skipped = 0, {}, [], 0
    for c in cases:
        bad, g = compare_motion(c, p, BAND_F32)
        more, n_skip = compare_hypotheses(c, g, p, BAND_F32)
        bad += more
        skipped += n_skip
        n_tied.append(len(tied(g, p)))
        fails += bool(bad)
        for b in bad:
            k = b.split(":")[0].split(" ")[0]
            kinds[k] = kinds.get(k, 0) + 1
    return {"tf32": tf32, "frames": len(cases), "failed_frames": fails,
            "kinds": kinds, "hypotheses": p.hypotheses * len(cases),
            "hypotheses_left_out": skipped,
            "tied_median": float(np.median(n_tied)),
            "won": sum(bool(c["ransac_ok"]) for c in cases),
            "health_min": min(float(c["health"]) for c in cases),
            "killed": sum(int(c["kill"].sum()) for c in cases),
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}


@pytest.mark.gpu
def test_card_gate_matches_reference_under_batch_traffic(cuda):
    """The compiled step on the card, under the cell's traffic: at least
    200 gated frames, every one within the tolerances, outputs and each
    hypothesis."""
    out = card_comparison(cuda, tf32=False)
    print("gate_reference " + json.dumps(out), flush=True)
    assert out["frames"] >= 200 and out["failed_frames"] == 0, out
