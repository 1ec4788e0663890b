"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device and the CUDA toolkit (nvcc); exits non-zero without
them. Phases, each of which raises on failure:

  1. build   — compiles the port's CUDA kernel from rsvio_tpu_torch/csrc/.
  2. kernel  — runs the KLT kernel (K1) and its plain PyTorch version on the
               same CUDA tensors at both main-path shapes (temporal pass:
               2 cameras x 256 slots; stereo match: 135 grid candidates) and
               requires equal ok on >= 99% of rows and |dpos| <= 1e-3 px
               where both are ok; times both (CUDA events, median of 25).
  3. agree   — runs the port's estimator step on a small scene on the CPU
               (plain KLT) and on the GPU (kernel) and requires the poses to
               agree within 1e-3.
  4. main    — the port's make_estimator_step at the EuRoC shape (752x480,
               6 levels, 256 slots, window 10, default EstimatorConfig) on
               the bench scene: 6 warm-up frames, 60 timed frames, a 20-frame
               blocked quality pass and a 10-frame per-stage split. Requires
               exactly 2 kernel launches per frame and the bench.py quality
               floors (tracked_mean >= 80, kill rate <= 0.3, finite pose,
               pose_ok on every frame, BA fired in the quality pass,
               drift <= 2%).

Prints the card's name and power limit, per-phase numbers, a JSON line
{"kernels": [...]} and, as the last line, {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

WARMUP, TIMED, QUAL, SPLIT = 6, 60, 20, 10
KERNEL_RUNS = 25
POS_TOL = 1e-3
REPLACES = "rsvio_tpu/ops/pallas/klt_kernel.py:737"
SOURCE = "rsvio_tpu_torch/csrc/klt_bidir.cu"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, runs=KERNEL_RUNS, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_phase(frames, dev):
    """K1 vs its plain version at the two main-path shapes."""
    import torch
    from rsvio_tpu_torch.ops import detect, pyramid
    from rsvio_tpu_torch.ops.cuda import klt_kernel as kk

    (l0, r0), (l1, r1) = frames[10], frames[11]
    pyrs = [pyramid.build_pyramid(im, 6) for im in (l0, r0, l1, r1)]
    gen = torch.Generator().manual_seed(0)
    # Temporal pass: 256 slots per camera, cam1 at the plane's disparity.
    p0 = torch.rand((256, 2), generator=gen) * torch.tensor([700.0, 430.0]) \
        + torch.tensor([25.0, 25.0])
    p1 = p0 - torch.tensor([458.0 * 0.11 / 5.0, 0.0])
    temporal = dict(
        src=kk.pack_pyramids([pyrs[0], pyrs[1]]),
        dst=kk.pack_pyramids([pyrs[2], pyrs[3]]),
        pos=torch.cat([p0, p1]).to(dev),
        alive=torch.ones(512, dtype=torch.bool, device=dev),
        cam=torch.cat([torch.zeros(256), torch.ones(256)]).to(
            torch.int32).to(dev))
    # Stereo match: the grid candidates of frame 11's left image.
    score = detect.fast_score(l1)
    cand, cand_ok = detect.select_grid_features(
        score, torch.zeros((1, 2), device=dev),
        torch.zeros(1, dtype=torch.bool, device=dev), 50)
    stereo = dict(src=kk.pack_pyramids([pyrs[2]]),
                  dst=kk.pack_pyramids([pyrs[3]]), pos=cand.contiguous(),
                  alive=cand_ok.contiguous(),
                  cam=torch.zeros(cand.shape[0], dtype=torch.int32,
                                  device=dev))
    results = {}
    for name, c in (("temporal", temporal), ("stereo", stereo)):
        (src, dims), (dst, _) = c["src"], c["dst"]
        args = (src, dst, dims, c["pos"], c["alive"], c["cam"])
        kw = dict(max_iterations=20, conv_thresh_sq=1e-4,
                  bidir_thresh_sq=0.4, coarse_tolerant=True)
        pk, _, okk = kk.klt_bidir(*args, **kw)
        torch.cuda.synchronize()
        pr, _, okr = kk.klt_bidir_reference(*args, **kw)
        agree = float((okk == okr).float().mean())
        both = okk & okr
        err = float((pk[both] - pr[both]).abs().max()) if bool(both.any()) \
            else 0.0
        ms = cuda_median_ms(lambda: kk.klt_bidir(*args, **kw))
        plain_ms = cuda_median_ms(lambda: kk.klt_bidir_reference(*args, **kw))
        n = c["pos"].shape[0]
        print(f"kernel[{name}] C={src.shape[0]} N={n}: ok kernel="
              f"{int(okk.sum())} plain={int(okr.sum())} agree={agree:.4f} "
              f"max|dpos|={err:.3g}px kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f}", flush=True)
        check(agree >= 0.99, f"{name}: ok agrees on only {agree:.4f}")
        check(err <= POS_TOL, f"{name}: max|dpos| {err} > {POS_TOL}")
        check(int(okk.sum()) >= n // 4, f"{name}: only {int(okk.sum())} ok")
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms)
    return results


def agree_phase(dev):
    """The port's step on a small scene, CPU (plain KLT) vs GPU (kernel)."""
    import torch
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator as est
    from rsvio_tpu_torch.models.frontend import FrontendConfig
    from rsvio_tpu_torch.ops.klt import KLTConfig

    shape = (96, 128)
    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=32, cell_size=24, detect_margin=10,
                                klt=KLTConfig(levels=3, max_iterations=8)),
        window_size=4, image_shape=shape)
    tex = bench_scene.make_texture(1, size=768,
                                   octaves=((90.0, 24), (60.0, 96)))
    kw = dict(shape=shape, fx=100.0, plane_z=4.0, scale=60.0, offset=200.0)
    frames = bench_scene.stereo_frames(tex, 10, step_m=0.02, **kw)
    step = est.make_estimator_step(cfg)
    worst = 0.0
    for d in (torch.device("cpu"), dev):
        rig = bench_scene.make_rig(d, shape=shape, fx=100.0)
        state = est.init_state(cfg, device=d)
        poses = []
        for a, b in frames:
            state, out = step(state, rig, a.to(d), b.to(d))
            poses.append(out.T_W_B.cpu())
        if d.type == "cpu":
            ref = poses
        else:
            worst = max(float((p - q).abs().max()) for p, q in zip(poses, ref))
    print(f"agree: small scene CPU vs GPU max|dT|={worst:.3g} over "
          f"{len(frames)} frames", flush=True)
    check(worst <= 1e-3, f"CPU and GPU steps disagree: {worst}")
    check(float(ref[-1][0, 3]) > 0.1, "small scene did not move")


def main_phase(frames, dev):
    import numpy as np
    import torch
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.models import estimator as est
    from rsvio_tpu_torch.ops.cuda import klt_kernel as kk

    cfg = est.EstimatorConfig()
    fe = cfg.frontend
    check((fe.capacity, fe.cell_size, fe.detect_margin, fe.klt.levels,
           fe.klt.max_iterations, cfg.window_size, tuple(cfg.image_shape))
          == (256, 50, 19, 6, 20, 10, (480, 752)),
          "default config is not the EuRoC bench shape")
    step = est.make_estimator_step(cfg)
    split = est.make_estimator_split_step(cfg)
    rig = bench_scene.make_rig(dev)
    state = est.init_state(cfg, device=dev)

    kk.klt_bidir.launches = 0
    k = 0
    for _ in range(WARMUP):
        state, out = step(state, rig, *frames[k])
        k += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        state, out = step(state, rig, *frames[k])
        k += 1
    torch.cuda.synchronize()
    fps = TIMED / (time.perf_counter() - t0)

    tracked, alive, step_ms = [], [], []
    ba_seen, pose_ok_all = 0, True
    for _ in range(QUAL):
        t1 = time.perf_counter()
        state, out = step(state, rig, *frames[k])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        k += 1
        tracked.append(int(out.n_tracked))
        alive.append(int(out.n_alive))
        ba_seen += int(out.ba_success)
        pose_ok_all = pose_ok_all and bool(out.pose_ok)
    kill = float(np.mean([1.0 - tracked[i] / max(alive[i - 1], 1)
                          for i in range(1, QUAL)]))
    x_final = float(out.T_W_B[0, 3])
    x_truth = bench_scene.STEP_M * (k - 1)
    drift = abs(x_final - x_truth) / max(abs(x_truth), 1e-9)

    stage_ms = {name: [] for name in est.STAGE_NAMES}
    for _ in range(SPLIT):
        state, out, times = split(state, rig, *frames[k])
        k += 1
        for name, v in times.items():
            stage_ms[name].append(v)
    launches = kk.klt_bidir.launches

    summary = {
        "frames_per_s": fps, "blocked_median_ms": statistics.median(step_ms),
        "tracked_mean": float(np.mean(tracked)), "bidir_kill_rate": kill,
        "x_final": x_final, "x_truth": x_truth, "drift_rel": drift,
        "ba_fires_in_quality_pass": ba_seen, "pose_ok": pose_ok_all,
        "stage_median_ms": {n: statistics.median(v)
                            for n, v in stage_ms.items()},
        "frames": k, "klt_launches": launches}
    print("main: " + json.dumps(summary), flush=True)
    check(launches == 2 * k, f"{launches} kernel launches for {k} frames")
    check(summary["tracked_mean"] >= 80.0, "tracked_mean < 80")
    check(kill <= 0.3, f"kill rate {kill} > 0.3")
    check(np.isfinite(x_final), "final pose not finite")
    check(pose_ok_all, "pose recovery fired in the quality pass")
    check(ba_seen >= 1, "BA never fired in the quality pass")
    check(drift <= 0.02, f"drift {drift} > 0.02")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rsvio_tpu_torch.data import bench_scene
    from rsvio_tpu_torch.ops.cuda import klt_kernel as kk
    from rsvio_tpu_torch.utils.precision import pin_fp32

    print(f"gpu: {gpu_name_and_power()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    pin_fp32()
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    built = kk.load_library()
    print(f"build: {time.perf_counter() - t0:.2f}s (nvcc {built.seconds:.2f}s)"
          f" {os.path.relpath(built.path)}", flush=True)
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    tex = bench_scene.make_texture(0).to(dev)
    n = WARMUP + TIMED + QUAL + SPLIT
    frames = bench_scene.stereo_frames(tex, n)
    torch.cuda.synchronize()
    print(f"render: {n} stereo frames in {time.perf_counter() - t0:.2f}s",
          flush=True)

    kres = kernel_phase(frames, dev)
    agree_phase(dev)
    launches = main_phase(frames, dev)

    print(json.dumps({"kernels": [{
        "name": "klt_bidir", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(r["err"] for r in kres.values()),
        "ms": kres["temporal"]["ms"], "plain_ms": kres["temporal"]["plain_ms"],
        "ms_stereo": kres["stereo"]["ms"],
        "plain_ms_stereo": kres["stereo"]["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
