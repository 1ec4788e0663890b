"""Interleaved A/B of the fused bidirectional KLT pass against the per-level
composition, both on the kernel route.

Port of tools/bench_tracker_fusion.py. The two routes compute the same
bidirectional track:
  * fused: ``ops.klt.track_points_bidirectional``, one ``klt_bidir``
    launch (K1);
  * composed: ``ops.klt.track_points`` forward, then backward from its
    result with the transposed forward warp, and the bidirectional distance
    gate: one ``klt_level`` launch (K2) a level and direction, 12 at 6
    levels.
On a 752x480 pair (uniform noise at 120x188, upsampled bicubic with
a = -0.75 as data/synthetic does where JAX calls cv2.resize(INTER_CUBIC),
a 5x5 sigma 1 Gaussian with reflect-101 borders, then shifted by
(1.3, -0.9) px, bilinear with reflect borders; the JAX tool's OpenCV calls
without OpenCV), 256 points drawn from default_rng(0) in [20, W-20] x
[20, H-20], KLTConfig(levels=6) on the kernel route.

Each route runs a chain of passes whose input positions are tied to the
last pass's output with a zero weight (the JAX tool's chained scan), with
one sync at the end, in interleaved epochs. Per route it prints ms a pass
over the chain (CUDA events on the card), the kernel launches and the host
syncs one pass makes (torch's sync debug mode; a route that syncs inside a
pass is not device-only time), and the survivors.

Usage:
  python -m rsvio_tpu_torch.tools.bench_tracker_fusion            # card
  python -m rsvio_tpu_torch.tools.bench_tracker_fusion --device cpu \\
      --chain 2 --epochs 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

# The benchmark's size (tests set smaller ones).
H, W, N, LEVELS = 480, 752, 256, 6
CHAIN, EPOCHS = 50, 4
SHIFT = (1.3, -0.9)       # px, the second frame's displacement (x, y)


def gaussian_5x5(img):
    """cv2.GaussianBlur(img, (5, 5), 1.0): the separable kernel of
    getGaussianKernel(5, 1.0), reflect-101 borders."""
    x = np.arange(5) - 2.0
    k = np.exp(-x * x / 2.0)
    k = torch.tensor(k / k.sum(), dtype=img.dtype, device=img.device)
    out = F.pad(img[None, None], (2, 2, 2, 2), mode="reflect")
    out = F.conv2d(out, k.view(1, 1, 1, 5))
    return F.conv2d(out, k.view(1, 1, 5, 1))[0, 0]


def shift_bilinear(img, dx, dy):
    """img displaced by (dx, dy) px: out(x, y) = img(x - dx, y - dy),
    bilinear, with reflect borders (edge pixels repeated), as
    cv2.warpAffine(INTER_LINEAR, BORDER_REFLECT) with a translation
    (without its 1/32 px quantization of the sample position)."""
    h, w = img.shape

    def taps(n, d):
        src = torch.arange(n, dtype=torch.float64, device=img.device) - d
        i0 = torch.floor(src)
        f = (src - i0).to(img.dtype)
        i0 = i0.to(torch.int64)

        def reflect(i):
            i = torch.where(i < 0, -i - 1, i)
            return torch.where(i >= n, 2 * n - i - 1, i)
        return reflect(i0), reflect(i0 + 1), f

    xa, xb, fx = taps(w, dx)
    ya, yb, fy = taps(h, dy)
    top = img[ya][:, xa] * (1 - fx) + img[ya][:, xb] * fx
    bot = img[yb][:, xa] * (1 - fx) + img[yb][:, xb] * fx
    return top * (1 - fy)[:, None] + bot * fy[:, None]


def make_inputs(device, seed=0):
    """(img0, img1, pts0 (N, 2) float32) on `device`, made as the JAX
    tool makes them: the noise first, then the points, from one
    default_rng(seed)."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(0, 255, (H // 4, W // 4)).astype(np.float32)
    base = F.interpolate(torch.from_numpy(noise).to(device)[None, None],
                         size=(H, W), mode="bicubic",
                         align_corners=False)[0, 0]
    img0 = gaussian_5x5(base)
    img1 = shift_bilinear(img0, *SHIFT)
    pts0 = torch.from_numpy(rng.uniform([20, 20], [W - 20, H - 20],
                                        size=(N, 2)).astype(np.float32))
    return img0, img1, pts0.to(device)


def composed(p0, p1, pts, alive, cfg):
    """track_points forward, backward from the result with the transposed
    forward warp, and the bidirectional gate: (pos_fwd, ok)."""
    from ..ops import klt
    eye = torch.eye(2, dtype=pts.dtype, device=pts.device).expand(
        pts.shape[0], 2, 2)
    pos_fwd, A_fwd, ok_fwd = klt.track_points(p0, p1, pts, pts, eye, alive,
                                              cfg)
    pos_back, _, ok_back = klt.track_points(p1, p0, pos_fwd, pts,
                                            A_fwd.transpose(-1, -2), ok_fwd,
                                            cfg)
    dist_sq = ((pos_back - pts) ** 2).sum(dim=1)
    return pos_fwd, ok_fwd & ok_back & (dist_sq < cfg.bidir_threshold_sq)


def fused(p0, p1, pts, alive, cfg):
    """One klt_bidir launch: (pos_fwd, ok)."""
    from ..ops import klt
    pos, _, ok = klt.track_points_bidirectional(p0, p1, pts, alive, cfg)
    return pos, ok


def setup(device):
    """The pyramids, points, alive mask and config of the benchmark."""
    from ..ops import klt, pyramid
    img0, img1, pts0 = make_inputs(device)
    p0 = pyramid.build_pyramid(img0, LEVELS)
    p1 = pyramid.build_pyramid(img1, LEVELS)
    alive = torch.ones(N, dtype=torch.bool, device=device)
    cfg = klt.KLTConfig(levels=LEVELS, backend="pallas")
    return p0, p1, pts0, alive, cfg


def chain(fn, p0, p1, pts0, alive, cfg, length):
    """`length` passes, each input tied to the last output with a zero
    weight; returns the last pass's (pos, ok)."""
    pts = pts0
    for _ in range(length):
        pos, ok = fn(p0, p1, pts, alive, cfg)
        pts = pts0 + 0.0 * pos
    return pos, ok


def host_syncs(fn, dev):
    """The host syncs torch's sync debug mode reports while fn() runs on a
    CUDA device, as "file:line" of the call that synced (none are possible
    on the CPU)."""
    if dev.type != "cuda":
        return []
    torch.cuda.synchronize(dev)
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    # Only the sync reports: the first switch to the debug mode also warns
    # that the mode is a prototype.
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in rec
            if "called a synchronizing CUDA operation" in str(w.message)]


def launches():
    from ..ops.cuda import klt_kernel as kk
    return {"klt_bidir": kk.klt_bidir.launches,
            "klt_level": kk.klt_level.launches}


def run(device="cuda", chain_len=CHAIN, epochs=EPOCHS):
    """The A/B; returns {route: {"ms": [ms a pass, one per epoch],
    "best_ms", "syncs" (one pass's, as file:line), "launches" (one pass),
    "survivors"}} and prints one line a route and the survivors."""
    dev = torch.device(device)
    p0, p1, pts0, alive, cfg = setup(dev)
    fns = {"fused": fused, "composed": composed}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    res = {}
    for name, fn in fns.items():
        pos, ok = chain(fn, p0, p1, pts0, alive, cfg, chain_len)  # warm
        sync()
        before = launches()
        syncs = host_syncs(lambda: fn(p0, p1, pts0, alive, cfg), dev)
        after = launches()
        res[name] = {"ms": [], "syncs": syncs,
                     "launches": {k: after[k] - before[k] for k in after},
                     "survivors": int(ok.sum())}
    for _ in range(epochs):
        for name, fn in fns.items():
            if dev.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                chain(fn, p0, p1, pts0, alive, cfg, chain_len)
                b.record()
                b.synchronize()
                ms = a.elapsed_time(b)
            else:
                t0 = time.perf_counter()
                chain(fn, p0, p1, pts0, alive, cfg, chain_len)
                ms = (time.perf_counter() - t0) * 1e3
            res[name]["ms"].append(ms / chain_len)
    for name, r in res.items():
        r["best_ms"] = min(r["ms"])
        print(f"{name:9s}: best {r['best_ms']:.4f} ms/pass  all "
              f"{[round(t, 4) for t in r['ms']]}  launches/pass "
              f"{json.dumps(r['launches'])}  host syncs/pass "
              f"{len(r['syncs'])} {sorted(set(r['syncs']))}", flush=True)
    print(f"survivors fused={res['fused']['survivors']} "
          f"composed={res['composed']['survivors']} (of {N})", flush=True)
    return res


def main(argv=None):
    from ..cli.run import add_device_arg, resolve_device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(ap)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{W}x{H}, {N} points, {LEVELS} levels, chain {args.chain}, "
          f"{args.epochs} epochs on {name}", flush=True)
    run(dev, args.chain, args.epochs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
