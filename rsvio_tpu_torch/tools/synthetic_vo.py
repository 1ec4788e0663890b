"""End-to-end demo: stereo VO on a synthetic textured-plane sequence.

Port of examples/synthetic_vo.py. Renders a stereo camera translating
sideways in front of a textured plane at known depth, runs the full
estimator (tracking -> triangulation -> PnP -> BA), and compares the
recovered trajectory to ground truth. The texture is 96x96 uniform noise
upscaled bicubically to 1536x1536 (``torch.nn.functional.interpolate``,
a = -0.75 as OpenCV's INTER_CUBIC) and sampled bilinearly on the device.
The step is the compiled one (models.estimator.make_compiled_estimator_step,
CUDA graphs of its segments), the example's jitted step; on the CPU the
same segments run eagerly.

Usage: python -m rsvio_tpu_torch.tools.synthetic_vo [--frames N]
    [--step M] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H, W = 240, 320
FX = FY = 200.0
CX, CY = W / 2, H / 2
BASELINE = 0.11
PLANE_Z = 5.0
TEX_SCALE = 100.0  # texture pixels per metre on the plane
TEX_OFF = 600.0


def make_texture(dev) -> torch.Tensor:
    """The demo's smooth random texture (1536x1536 float32 on dev)."""
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.uniform(40, 220, (96, 96))
                             .astype(np.float32)).to(dev)
    return F.interpolate(noise[None, None], size=(1536, 1536),
                         mode="bicubic", align_corners=False)[0, 0]


def render(tex, cam_t) -> torch.Tensor:
    """The plane seen from a camera at world position cam_t (no
    rotation), (H, W) float32."""
    from ..data.synthetic import remap_replicate

    dev = tex.device
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    depth = PLANE_Z - float(cam_t[2])
    Xw = (u - CX) / FX * depth + float(cam_t[0])
    Yw = (v - CY) / FY * depth + float(cam_t[1])
    return remap_replicate(tex, Xw * TEX_SCALE + TEX_OFF,
                           Yw * TEX_SCALE + TEX_OFF)


def main(argv=None):
    from ..cli.run import fetch, resolve_device
    from ..models import estimator as est
    from ..models.frontend import FrontendConfig
    from ..ops import cameras
    from ..ops.klt import KLTConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("--step", type=float, default=0.02,
                    help="m per frame in x")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    tex = make_texture(dev)
    params = cameras.pack_params(cameras.PINHOLE_RADTAN, [FX, FY, CX, CY],
                                 [0, 0, 0, 0], device=dev)
    T_B_Cr = torch.eye(4, device=dev)
    T_B_Cr[0, 3] = BASELINE
    rig = est.make_rig(params, params, torch.eye(4, device=dev), T_B_Cr)
    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=128, cell_size=40, detect_margin=12,
                                klt=KLTConfig(levels=4)),
        window_size=6,
        translation_threshold=0.03,
        rotation_threshold=0.05,
        image_shape=(H, W),
    )
    step = est.make_compiled_estimator_step(cfg, device=dev)
    state = est.init_state(cfg, device=dev)

    print("running...")
    gt, rec = [], []
    t0 = time.time()
    for k in range(args.frames):
        cam = np.array([args.step * k, 0.0, 0.0])
        img_l = render(tex, cam)
        img_r = render(tex, cam + np.array([BASELINE, 0, 0]))
        state, out = step(state, rig, img_l, img_r)
        o = fetch({"pos": out.T_W_B[:3, 3], "kf": out.is_keyframe,
                   "pnp": out.pnp_success, "ba": out.ba_success,
                   "tracked": out.n_tracked, "lm": out.n_landmarks})
        p = o["pos"]
        gt.append(cam.copy())
        rec.append(p)
        print(f"frame {k:3d} kf={int(o['kf'])} pnp={int(o['pnp'])} "
              f"ba={int(o['ba'])} tracked={int(o['tracked'])} "
              f"lm={int(o['lm'])} "
              f"pos=[{p[0]:+.3f} {p[1]:+.3f} {p[2]:+.3f}] gt_x={cam[0]:+.3f}")
    dt = time.time() - t0
    gt = np.array(gt)
    rec = np.array(rec, dtype=np.float64)

    # Evaluate on the second half (after the window fills and BA engages),
    # aligning start positions.
    half = args.frames // 2
    d_gt = gt[-1] - gt[half]
    d_rec = rec[-1] - rec[half]
    err = np.linalg.norm(d_rec - d_gt)
    rel = err / max(np.linalg.norm(d_gt), 1e-9)
    print(f"\n{args.frames} frames in {dt:.1f}s "
          f"({args.frames / dt:.2f} fps incl. kernel build)")
    print(f"GT displacement (2nd half):  {d_gt}")
    print(f"Est displacement (2nd half): {d_rec}")
    print(f"error {err:.4f} m ({rel * 100:.1f}% of GT displacement)")
    ok = rel < 0.2
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
