"""The benchmark scene, rendered without OpenCV.

The same geometry as the JAX package's ``bench.py``: a textured plane 5 m in
front of a pinhole stereo rig (fx = fy = 458, principal point at the image
center, 0.11 m baseline, no distortion) translating along x by 0.03 m per
frame, at the EuRoC shape 752x480. Ground truth is known: the pose after
frame k is x = 0.03 k (``truth_position``).

``render_rig`` renders the same plane through any ``CameraRig``: each
camera's model and calibration, the rig's extrinsics, the plane 5 m in front
of the left camera at frame 0, the rig moving 0.03 m a frame along the left
camera's x axis.

The multi-scale texture is a sum of bicubic upscales of uniform noise
(``torch.nn.functional.interpolate``, on the CPU); frames are a bilinear
remap of it with reflected borders. It does not match the OpenCV render
pixel for pixel, but it is the same kind of scene.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

H, W = 480, 752
FX = FY = 458.0
CX, CY = W / 2, H / 2
BASELINE_M = 0.11
PLANE_Z = 5.0
STEP_M = 0.03
TEX_SIZE = 3072
TEX_SCALE = 120.0     # texture pixels per metre on the plane
TEX_OFFSET = 1300.0   # texture pixel of the plane's origin
OCTAVES = ((90.0, 96), (60.0, 384), (40.0, 1024))   # (weight, noise size)


def make_texture(seed: int = 0, size: int = TEX_SIZE,
                 octaves=OCTAVES) -> torch.Tensor:
    """(size, size) float32 texture on the CPU: sum of weighted bicubic
    upscales of uniform noise, plus 40."""
    rng = np.random.default_rng(seed)
    tex = torch.full((size, size), 40.0)
    for w, n in octaves:
        noise = torch.from_numpy(rng.uniform(0, 1, (n, n)).astype(np.float32))
        up = F.interpolate(noise[None, None], size=(size, size),
                           mode="bicubic", align_corners=False)[0, 0]
        tex += w * up
    return tex


def _reflect(i, n: int):
    """Index reflection with the edge pixel repeated, OpenCV's
    BORDER_REFLECT: fedcba|abcdef|fedcba."""
    period = 2 * n
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - 1 - i, i)


def remap_bilinear(tex, mx, my):
    """Bilinear sample of tex (Ht, Wt) at float maps mx, my (H, W), borders
    reflected."""
    Ht, Wt = tex.shape
    x0 = torch.floor(mx)
    y0 = torch.floor(my)
    fx = mx - x0
    fy = my - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    xa, xb = _reflect(x0, Wt), _reflect(x0 + 1, Wt)
    ya, yb = _reflect(y0, Ht), _reflect(y0 + 1, Ht)
    top = tex[ya, xa] * (1 - fx) + tex[ya, xb] * fx
    bot = tex[yb, xa] * (1 - fx) + tex[yb, xb] * fx
    return top * (1 - fy) + bot * fy


def render(tex, cam_x: float, cam_y: float = 0.0, shape=(H, W),
           fx: float = FX, plane_z: float = PLANE_Z,
           scale: float = TEX_SCALE, offset: float = TEX_OFFSET,
           roll: float = 0.0):
    """(H, W) float32 image of the plane seen by a camera at (cam_x, cam_y),
    rolled by `roll` radians about its optical axis, on tex's device."""
    h, w = shape
    dev = tex.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    du, dv = u - w / 2, v - h / 2
    if roll:
        c, s = math.cos(roll), math.sin(roll)
        du, dv = c * du - s * dv, s * du + c * dv
    x = du / fx
    y = dv / fx
    mx = (x * plane_z + cam_x) * scale + offset
    my = (y * plane_z + cam_y) * scale + offset
    return remap_bilinear(tex, mx, my)


def stereo_frames(tex, n_frames: int, step_m: float = STEP_M,
                  baseline_m: float = BASELINE_M, **kw):
    """List of (left, right) frames for frames 0..n_frames-1."""
    return [(render(tex, step_m * k, **kw),
             render(tex, step_m * k + baseline_m, **kw))
            for k in range(n_frames)]


def truth_position(rig, k: int, step_m: float = STEP_M):
    """(3,) body position after frame k in the estimator's world (the body
    frame at frame 0): k step_m along the left camera's x axis, for the
    scenes of ``stereo_frames`` with ``make_rig`` and of ``render_rig``."""
    return k * step_m * rig.T_B_C[0, :3, 0]


def render_rig(tex, rig, kinds, k: int, shape, step_m: float = STEP_M,
               plane_dist: float = PLANE_Z, scale: float = None,
               offset: float = TEX_OFFSET, fade=(math.radians(45.0),
                                                 math.radians(60.0))):
    """(left, right) float32 images of frame k seen through `rig` (a
    CameraRig; `kinds` the two camera models), on tex's device.

    Each pixel is unprojected with its camera's model, rotated into the
    world by T_W_B T_B_C (T_W_B a pure translation, ``truth_position``) and
    intersected with the plane through the left camera's frame-0 centre +
    plane_dist along its optical axis, normal to that axis; the plane's
    texture axes are the left camera's frame-0 x and y axes, `scale`
    texels a metre (default TEX_SCALE fx / FX: a centre pixel covers as
    many texels as in the main scene).

    Near grazing rays the plane is seen so far away and so obliquely that
    the texture aliases, and fisheye pixels beyond the model's 90-degree
    ray see no plane at all. So between the angles fade[0] and fade[1]
    from the plane's normal the image fades smoothly to the texture's mean,
    and beyond fade[1] it is that constant: no corners and no edge there
    for the detector to give birth to tracks that do not move with the
    plane. (Textured but clamped rays there — the texture at the clamped
    ray — were tracked and biased the pose by a few percent.)"""
    from ..ops import cameras

    h, w = shape
    dev = tex.device
    T_B_C = rig.T_B_C.to(device=dev, dtype=torch.float32)
    params = rig.params.to(device=dev, dtype=torch.float32)
    if scale is None:
        scale = TEX_SCALE * float(params[0, 0]) / FX
    ex, ey, n = T_B_C[0, :3, 0], T_B_C[0, :3, 1], T_B_C[0, :3, 2]
    X0 = T_B_C[0, :3, 3] + plane_dist * n
    body = truth_position(rig, k, step_m).to(device=dev, dtype=torch.float32)
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev),
                          indexing="ij")
    uv = torch.stack([u, v], dim=-1)
    c_min, s_min = math.cos(fade[1]), math.sin(fade[1])
    fill = tex.mean()
    out = []
    for cam in (0, 1):
        xy = cameras.unproject(kinds[cam], params[cam], uv)
        d = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
        if kinds[cam].lower() == cameras.EUCM:
            # Beyond 90 degrees the normalized coordinates are those of
            # the opposite ray; they do not project back to the pixel.
            back, _ = cameras.project(kinds[cam], params[cam], d)
            behind = ((back - uv).abs() > 0.5).any(dim=-1)
            d = torch.where(behind[..., None], -d, d)
        d = d @ T_B_C[cam, :3, :3].T
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        cos_t = d @ n
        ramp = torch.clamp((torch.acos(torch.clamp(cos_t, -1.0, 1.0))
                            - fade[0]) / (fade[1] - fade[0]), 0.0, 1.0)
        perp = d - cos_t[..., None] * n
        perp = perp / torch.clamp(torch.linalg.vector_norm(
            perp, dim=-1, keepdim=True), min=1e-9)
        d = torch.where((cos_t < c_min)[..., None], c_min * n + s_min * perp,
                        d)
        o = body + T_B_C[cam, :3, 3]
        X = o + (((X0 - o) @ n) / (d @ n))[..., None] * d
        mx = ((X - X0) @ ex) * scale + offset
        my = ((X - X0) @ ey) * scale + offset
        out.append(torch.lerp(remap_bilinear(tex, mx, my), fill,
                              ramp * ramp * (3.0 - 2.0 * ramp)))
    return tuple(out)


def make_rig(device="cuda", shape=(H, W), fx: float = FX,
             baseline_m: float = BASELINE_M):
    """The scene's stereo rig as the port's CameraRig."""
    from ..models.estimator import make_rig as _make_rig
    from ..ops import cameras

    h, w = shape
    params = cameras.pack_params(cameras.PINHOLE_RADTAN,
                                 [fx, fx, w / 2, h / 2], [0, 0, 0, 0],
                                 device=device)
    T_r = torch.eye(4, device=device)
    T_r[0, 3] = baseline_m
    return _make_rig(params, params.clone(), torch.eye(4, device=device), T_r)
