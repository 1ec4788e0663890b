"""TartanAir mono feature-tracking entry point.

Port of rsvio_tpu/cli/run_tartanair.py (ref
feature_tracker/src/bin/play_tartanair.rs + players/tartanair_player.rs):
drives the mono tracker (temporal bidirectional KLT + Shi-Tomasi births)
over a TartanAir ``image_left`` sequence, capped at 800 frames, with the
viewer hooks. The tracker YAML of the experimental crate maps as in the JAX
package; a non-zero ``optical_flow_lm_lambda`` stays on the KLT kernel (the
JAX CLI's warning that it leaves the kernel is stale there too). Each
frame's tracked / alive counts (with a viewer, also the table, pyramid and
score map) are read with one device-to-host copy. On the card the frame's
pyramid build and step run as CUDA graphs (models/mono_tracker.
make_compiled_mono_step); the viewer's score map is computed outside them.

    python -m rsvio_tpu_torch.cli.run_tartanair <seq> [--config <yaml>]
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .run import (PlayerResult, add_device_arg, fetch, resolve_device,
                  setup_logging, uploader)

log = logging.getLogger("rsvio")


@dataclass
class MonoResult(PlayerResult):
    """PlayerResult plus each frame's tracked and alive counts."""
    tracked: List[int] = field(default_factory=list)
    alive: List[int] = field(default_factory=list)


def _load_tracker_yaml(path):
    """Parse the experimental-crate tracker config schema (ref
    feature_tracker/config/config.yaml: nlevels / ratio / preprocessing_blur
    / detection_* / optical_flow_*). Unknown keys are ignored, like the
    reference's serde."""
    from ..utils.config import load_yaml_stripped
    return load_yaml_stripped(path)


def tracker_settings(config_path, levels: int = 4, capacity: int = 256):
    """(MonoTrackerConfig, make_pyramid) from the CLI defaults (the ref
    mono PatchTracker: 30 iterations, 0.005, grid 30) and, if given, the
    tracker YAML, mapped as the JAX CLI maps it."""
    from ..models import mono_tracker as mt
    from ..ops import pyramid
    from ..ops.klt import KLTConfig

    down, blur, blur_sigma = 2.0, False, 0.7
    max_iter, lm_lambda = 30, 0.0
    cell_size, min_score = 30, 1.0
    detect_mode, nms_radius = "grid", 10
    if config_path:
        y = _load_tracker_yaml(config_path)
        levels = int(y.get("nlevels", levels))
        down = float(y.get("ratio", down))       # per-level downscale factor
        blur = bool(y.get("preprocessing_blur", blur))
        blur_sigma = float(y.get("preprocessing_blur_sigma", blur_sigma))
        max_iter = int(y.get("optical_flow_max_iter", max_iter))
        lm_lambda = float(y.get("optical_flow_lm_lambda", lm_lambda))
        cell_size = int(y.get("detection_min_dist", cell_size))
        if "detection_min_dist" in y:
            # True min-dist semantics: block NMS with live-track suppression
            # (ref feature_detection.rs:172-254, 62-69).
            detect_mode, nms_radius = "nms", int(y["detection_min_dist"])
        # Threshold in reference units: its score carries x1000 on the
        # min eigenvalue and its [-1,0,1] gradients a ~4x larger structure
        # tensor than the 0.5-scaled central differences here: / 4000.
        if "detection_threshold" in y:
            min_score = float(y["detection_threshold"]) / 4000.0

    cfg = mt.MonoTrackerConfig(
        capacity=capacity, cell_size=cell_size, min_score=min_score,
        detect_mode=detect_mode, nms_radius=nms_radius,
        klt=KLTConfig(levels=levels, max_iterations=max_iter,
                      convergence_threshold=0.005, lm_lambda=lm_lambda,
                      pyramid_ratio=1.0 / down))

    def make_pyramid(img):
        if down == 2.0 and not blur:
            return pyramid.build_pyramid(img, levels)
        return pyramid.build_pyramid_ratio(img, levels, 1.0 / down, blur=blur,
                                           blur_sigma=blur_sigma)

    return cfg, make_pyramid


def main(argv=None):
    """Returns the exit code; the run's MonoResult is kept in
    ``main.last_result``."""
    ap = argparse.ArgumentParser(description="Run TartanAir mono tracking")
    ap.add_argument("dataset_path", help="sequence dir containing image_left/")
    ap.add_argument("--config", default=None,
                    help="tracker YAML (experimental-crate schema: nlevels, "
                         "ratio, preprocessing_blur, detection_min_dist, "
                         "detection_threshold, optical_flow_max_iter, "
                         "optical_flow_lm_lambda)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--viewer", action="store_true")
    ap.add_argument("--viewer-dir", default=None)
    ap.add_argument("--quiet", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    setup_logging(verbose=not args.quiet)
    np.random.seed(42)

    import torch

    from ..data.players import TartanAirPlayer, prefetch_frames
    from ..models import mono_tracker as mt
    from ..ops import detect
    from ..viewers import NullViewer, create_viewer

    dev = resolve_device(args.device)
    player = TartanAirPlayer(args.dataset_path)
    n = len(player) if args.max_frames is None else min(args.max_frames,
                                                        len(player))
    log.info("TartanAir: %d frames (processing %d) on %s", len(player), n,
             dev)
    viewer = create_viewer(args.viewer, args.viewer_dir)
    viewer_on = not isinstance(viewer, NullViewer)
    cfg, make_pyramid = tracker_settings(args.config, args.levels,
                                         args.capacity)
    table = mt.init_mono_table(args.capacity, device=dev)
    upload = uploader(dev, torch.float32)
    # On the card the pyramid build and the step run as CUDA graphs, as the
    # JAX CLI runs its jitted step.
    compiled = (mt.make_compiled_mono_step(cfg, make_pyramid, device=dev)
                if dev.type == "cuda" else None)

    res = MonoResult()
    pyr_prev = None
    frames = prefetch_frames(player, 0, n,
                             pin=dev.type == "cuda",
                             decode_ms=res.decode_times_ms)
    try:
        for k, frame in enumerate(frames):
            t0 = time.time()
            img = upload(frame.tensors[0])
            if compiled is not None:
                table, stats = compiled(table, img, first_frame=k == 0)
                pyr = compiled.pyramid
            else:
                pyr = make_pyramid(img)
                table, stats = mt.mono_tracker_step(
                    table, pyr_prev if pyr_prev is not None else pyr, pyr,
                    cfg, first_frame=(pyr_prev is None))
            reads = dict(stats)
            if viewer_on:
                reads.update(alive_mask=table.alive, pos=table.pos,
                             fid=table.fid,
                             score=detect.shi_tomasi_score(pyr[0]),
                             **{f"level{i}": lv for i, lv in enumerate(pyr)})
            h = fetch(reads)
            pyr_prev = pyr
            res.frame_processing_times_ms.append((time.time() - t0) * 1000.0)
            res.tracked.append(int(h["tracked"]))
            res.alive.append(int(h["alive"]))
            log.debug("[Timing] frame %d: %.1f ms | tracked=%d alive=%d",
                      k, res.frame_processing_times_ms[-1], res.tracked[-1],
                      res.alive[-1])
            if viewer_on:
                viewer.set_frame(k, frame.timestamp_ns)
                alive = h["alive_mask"]
                pos = h["pos"][alive]
                fids = h["fid"][alive]
                viewer.log_image_with_features_colored(
                    "tartanair/left", frame.left, pos, fids)
                # FT debug surface (ref feature_tracker/src/viewer.rs:6-97):
                # id-labeled points at pixel centers, the pyramid levels and
                # the corner-score map, colormapped.
                viewer.log_labeled_points("tartanair/labels", pos,
                                          [str(int(f)) for f in fids])
                viewer.log_pyramid("tartanair/pyramid",
                                   [h[f"level{i}"] for i in range(len(pyr))])
                viewer.log_float_map("tartanair/shi_tomasi", h["score"])
    finally:
        frames.close()
    main.last_result = res
    times = res.frame_processing_times_ms
    if times:
        res.avg_processing_time_ms = float(np.mean(times))
        res.success = True
        log.info("%d frames, avg %.2f ms (%.1f fps)", len(times),
                 res.avg_processing_time_ms,
                 1000.0 / res.avg_processing_time_ms)
        return 0
    return -1


main.last_result = None

if __name__ == "__main__":
    raise SystemExit(main())
