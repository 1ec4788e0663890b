"""Run one cell of the benchmark of rsvio_tpu_torch on an NVIDIA GPU.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json) names a
configuration (configs/<name>.json) and a traffic mix
(traffic/<name>.json). Set-up makes each stream's loop of frames and IMU
buffers from the seed, builds the compiled steps and warms every variant
the loop meets; then the window runs for --seconds. After it, the plain
reference judges every frame's pose and the sampled frames' states
(checks.py), and the last line of standard output is the result: correct,
attempted, failed, the cell's end-to-end metrics (--trace 0) or its
per-layer metrics (--trace 1, from a torch.profiler slice at the window's
end), the device, and last the numbers compared with their limits.
Earlier lines give set-up's parts and the card's clocks, power and
temperature before and after the window.

Exits 2 without printing a result when no CUDA device is there, or fewer
than the cell asks for.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import subprocess  # noqa: E402
import sys        # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rsvio_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was first run."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def forbidden_modules():
    """Modules loaded whose top-level name is one the run must not load,
    compared whole (rsvio_tpu_torch is not rsvio_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_sample():
    """The card's clocks, power and temperature (nvidia-smi), or None."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip() or None


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


class RunData:
    """What the per-layer readers read (readers.py)."""

    def __init__(self):
        self.spans = []          # (t0, t1, is_kf) of window frames
        self.captures_before = self.captures_after = 0
        self.trace = None
        self.slice_frames = []   # (n_alive before, n_alive, n_tracked)
        self.levels = 0


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench=None, conf=None, traffic=None,
             limits=None, control: str = None, fault=None):
    """One run of a cell; returns the result dict (without printing).
    conf / traffic / limits replace the cell's files (tests run small
    sizes on the CPU); control="tf32" lets the program's float32 products
    run in TF32 (the correctness control); fault(stream) may wrap a
    stream's step (the tests' planted faults)."""
    from . import spec

    parts = {"before_run_cell_s": process_age_s()}
    t = time.perf_counter()
    import numpy as np
    import torch
    parts["import_torch_s"] = time.perf_counter() - t

    bench = bench or spec.load_benchmark()
    cell = spec.cell(bench, cell_name)
    conf = conf or spec.config(cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    limits = limits if limits is not None else spec.limits(cell_name)
    dev = torch.device(device)

    t = time.perf_counter()
    from . import checks, drive, scene
    from .trace import Slice
    drive.import_program()
    parts["import_program_s"] = time.perf_counter() - t

    if dev.type == "cuda":
        t = time.perf_counter()
        parts["extension_compile_s"] = drive.load_kernels()
        parts["extension_s"] = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats(dev)

    t = time.perf_counter()
    program = drive.Program(conf, dev)
    rig = scene.rig_from_config(conf["config"])
    loop = scene.loop_from_traffic(traffic)
    plane = scene.make_plane(loop, rig, float(traffic["plane_dist_m"]))
    S = int(traffic["streams"])
    starts = [scene.start_frame(i, S, loop.frames) for i in range(S)]
    parts["program_config_s"] = time.perf_counter() - t

    t = time.perf_counter()
    rnd = scene.Renderer(rig, plane, dev)
    frames = []
    for i in range(S):
        tex = scene.make_texture(seed + i, dev)
        frames.append(scene.render_loop(rnd, loop, tex,
                                        dev.type == "cuda"))
    del rnd, tex
    parts["frames_s"] = time.perf_counter() - t

    t = time.perf_counter()
    imus, buffers = [], []
    imu_cfg = conf.get("imu")
    if program.kind == "vio":
        for i in range(S):
            rng = np.random.default_rng([seed % (2 ** 63), i])
            imu = scene.make_imu(loop, rig, imu_cfg, rng,
                                 starts[i] / loop.fps,
                                 float(imu_cfg["static_head_s"]))
            imus.append(imu)
            buffers.append(scene.frame_imu_buffers(imu, loop,
                                                   int(imu_cfg["buffer"])))
    parts["imu_s"] = time.perf_counter() - t

    t = time.perf_counter()
    streams = []
    for i in range(S):
        s = drive.Stream(i, starts[i], frames[i],
                         buffers[i] if buffers else None, program,
                         float(traffic["snapshot_share"]),
                         np.random.default_rng([seed % (2 ** 63), 1000 + i]))
        s.state = program.initial_state(imus[i] if imus else None)
        if fault is not None:
            fault(s)
        streams.append(s)
    parts["steps_s"] = time.perf_counter() - t
    if control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")

    # Warm-up: one stream at a time, until it has met every variant of its
    # frames; for VIO, then every interval length (drive.warm_intervals).
    W = program.window
    if program.kind == "vio":
        def need(st):
            u = st.step.graphs.uses
            return ("kf", False) in u and ("kf", True, True) in u
    else:
        def need(st):
            u = st.step.graphs.uses
            return ("opt", False, False) in u and ("opt", True, True) in u
    warm = [drive.warm(s, need, W + 2 * loop.frames) for s in streams]
    parts["warmup_s"] = [round(w["s"], 3) for w in warm]
    parts["warmup_frames"] = [w["frames"] for w in warm]
    parts["captures"] = [w["captures"] for w in warm]

    run = RunData()
    run.levels = int(conf["config"]["tracker"]["pyramid_levels"])
    run.captures_before = sum(drive.capture_count(s.step) for s in streams)
    first = [len(s.records) for s in streams]
    for s in streams:
        s.sampling = True
    slicer = Slice() if trace else None
    slice_s = float(traffic["trace_seconds"]) if trace else 0.0
    if trace:
        slicer.init()
        parts["trace_init_s"] = slicer.init_s
    cards = {"before": card_sample() if dev.type == "cuda" else None}
    setup_s = process_age_s()
    parts["setup_s"] = setup_s
    log("portbench setup " + json.dumps(parts))

    if traffic["mode"] == "open":
        t0, t_end, due = drive.run_open(streams[0], seconds,
                                        float(traffic["rate_hz"]), slicer,
                                        slice_s)
    else:
        t0, t_end = drive.run_closed(streams, seconds,
                                     threads=dev.type == "cuda",
                                     slicer=slicer, slice_s=slice_s)
        due = None
    run.captures_after = sum(drive.capture_count(s.step) for s in streams)
    if dev.type == "cuda":
        # Were a variant captured inside the window, its capture would have
        # switched the process-wide sync-debug mode from its stream's
        # thread (captures_in_window counts such captures). The host reads
        # below are the harness's own.
        torch.cuda.set_sync_debug_mode(0)
    if trace:
        cards["trace_start_s"] = slicer.start_s
    cards["after"] = card_sample() if dev.type == "cuda" else None
    log("portbench card " + json.dumps(cards))

    found = forbidden_modules()
    if found:
        raise RuntimeError("loaded in the benchmark's process: "
                           + ", ".join(found))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    # The window's frames: rates, latencies and spans.
    done = []
    for s, f in zip(streams, first):
        for (k, j, a, b, is_kf) in s.records[f:]:
            done.append(b)
            in_slice = trace and b >= slicer.t_arm
            if not in_slice:
                run.spans.append((a, b, is_kf))
    metrics_e2e = {}
    if due is not None:
        lat = latencies_ms(due, [r[3] for r in streams[0].records[first[0]:]],
                           t_end)
        metrics_e2e["latency_p95_ms"] = float(np.percentile(lat, 95))
    else:
        metrics_e2e["frames_per_s"] = frames_per_s(done, t0, t_end)
    metrics_e2e["setup_s"] = setup_s

    if trace:
        run.trace = slicer.reduce()
        for s, f in zip(streams, first):
            for idx in range(max(f, 1), len(s.records)):
                b = s.records[idx][3]
                if slicer.t_start <= b <= slicer.t_stop:
                    run.slice_frames.append((s.counts[idx - 1][0],
                                             *s.counts[idx]))

    # The reference, once the program's state is freed.
    host = []
    for s, f in zip(streams, first):
        host.append({"start": s.start, "first": f,
                     "poses": np.stack(s.poses).reshape(-1, 4, 4),
                     "vel": np.stack(s.vel) if s.vel else None,
                     "kf": np.array([r[4] for r in s.records]),
                     "snaps": [drive.snapshot_to_host(x) for x in s.snaps],
                     "buffers": s.imu})
        s.step = s.state = None
        s.snaps = []
    streams = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    t = time.perf_counter()
    nums, attempted, failed = checks.judge(
        host, loop, rig, plane, W, int(traffic["span_frames"]), program.kind,
        imu_cfg)
    ref_s = time.perf_counter() - t
    correct, compared = checks.verdict(nums, limits.get("limits", {}),
                                       failed)
    info = {k: v for k, v in nums.items() if k not in compared}
    log("portbench reference " + json.dumps(
        {"seconds": ref_s, "attempted": attempted, "failed": failed,
         "info": info}))

    result = {"correct": correct, "attempted": attempted, "failed": failed}
    wanted = spec.metrics_for(bench, cell_name, trace)
    out = {}
    if trace:
        for m in wanted:
            v = spec.metric_reader(m["name"])(run)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in wanted:
            if m["name"] in metrics_e2e:
                out[m["name"]] = {"value": metrics_e2e[m["name"]],
                                  "unit": m["unit"]}
    result["metrics"] = out
    result["device"] = device_info(dev, peak)
    if trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = compared
    return result


def latencies_ms(due, done, t_end):
    """Each due frame's latency (ms): from its due time until its pose was
    on the host; a frame not done by the window's end counts at its age
    then. `done` holds the done times of the frames in due order (a frame
    that never ran is missing at the end)."""
    out = []
    for k, d in enumerate(due):
        end = done[k] if k < len(done) and done[k] <= t_end else t_end
        out.append((end - d) * 1e3)
    return out


def frames_per_s(done, t0, t_end):
    """Frames completed by all streams in the window over its seconds."""
    return sum(1 for b in done if t0 <= b <= t_end) / (t_end - t0)


def device_info(dev, peak):
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None,
                    help="the correctness control: the program's float32 "
                         "products in TF32 (never in a measured run)")
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from . import spec
    bench = spec.load_benchmark()
    chips = spec.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench, control=args.control)
    found = forbidden_modules()
    if found:
        log("portbench: loaded in this process: " + ", ".join(found))
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
