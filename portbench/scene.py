"""The benchmark's scene: a textured plane seen through a stereo rig that
flies a closed 6-dof loop, with its exact poses and a 200 Hz IMU.

Plain numpy and PyTorch; nothing here imports the program. The renderer is
a frozen copy of the port's ``data/bench_scene.render_rig`` extended from a
translating body to a 6-dof body pose, with its own camera model.

Geometry. World z is up, gravity (0, 0, -9.81). The left camera is level
at the loop's reference pose (t = 0): its x axis along world x, its y axis
down, its optical axis along world +y. The plane stands ``plane_dist``
metres ahead of that camera, normal to its axis; its texture axes are the
camera's x and y axes. The body's attitude is R_W_C(t) R_B_C^T with R_W_C(t)
= R_LEVEL Rz(a0) Ry(a1) Rx(a2) (angles about the left camera's own axes) and
its position ``p(t)`` (the body origin, the IMU), each a sum of sines with
whole-number periods that divide the loop, so pose, velocity and IMU repeat
exactly every loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

GRAVITY = 9.81
GRAVITY_W = np.array([0.0, 0.0, -GRAVITY])
# Columns are the level camera's axes in the world: x -> world x, y (down)
# -> world -z, z (optical axis) -> world +y.
R_LEVEL = np.array([[1.0, 0.0, 0.0],
                    [0.0, 0.0, 1.0],
                    [0.0, -1.0, 0.0]])
TEX_SIZE = 3072
TEX_PER_M = 120.0 / 458.0     # texels per metre per pixel of focal length
TEX_OFFSET = 1300.0           # texel of the plane's origin
OCTAVES = ((90.0, 96), (60.0, 384), (40.0, 1024))   # (weight, noise size)
FADE = (math.radians(45.0), math.radians(60.0))


# ---------------------------------------------------------------------------
# Camera model (pinhole with radial-tangential distortion)
# ---------------------------------------------------------------------------

def distort(params, xy):
    """Normalized undistorted (..., 2) -> distorted, params (fx, fy, cx, cy,
    k1, k2, p1, p2)."""
    k1, k2, p1, p2 = params[4:8]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def project(params, P):
    """Camera-frame points (..., 3) -> pixels (..., 2); numpy or torch."""
    z = P[..., 2]
    xy = P[..., :2] / z[..., None]
    xd, yd = distort(params, xy)
    lib = torch if torch.is_tensor(P) else np
    return lib.stack([params[0] * xd + params[2],
                      params[1] * yd + params[3]], -1)


def unproject(params, uv, iterations: int = 40):
    """Pixels (..., 2) -> normalized undistorted coordinates (..., 2), by
    fixed-point iteration of the distortion; numpy or torch."""
    xd = (uv[..., 0] - params[2]) / params[0]
    yd = (uv[..., 1] - params[3]) / params[1]
    k1, k2, p1, p2 = params[4:8]
    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2
        x = (xd - 2 * p1 * x * y - p2 * (r2 + 2 * x * x)) / rad
        y = (yd - p1 * (r2 + 2 * y * y) - 2 * p2 * x * y) / rad
    lib = torch if torch.is_tensor(uv) else np
    return lib.stack([x, y], -1)


@dataclass(frozen=True)
class Rig:
    """The stereo rig: image shape (H, W), per camera the 8 parameters and
    T_B_C (4x4, camera to body), float64 numpy."""
    shape: tuple
    params: tuple
    T_B_C: tuple


def rig_from_config(cfg: dict) -> Rig:
    """The rig of a configuration file's `config.camera` section."""
    cam = cfg["camera"]
    params, T = [], []
    for side in ("left", "right"):
        params.append(np.array(list(cam[f"{side}_intrinsics"])
                               + list(cam[f"{side}_distortion"]), float))
    for key in ("T_B_Cl", "T_B_Cr"):
        T.append(np.array(cam[key], float).reshape(4, 4))
    return Rig((int(cam["image_height"]), int(cam["image_width"])),
               tuple(params), tuple(T))


# ---------------------------------------------------------------------------
# Trajectory
# ---------------------------------------------------------------------------

def _rx(a):
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones_like(a), np.zeros_like(a)
    return np.stack([np.stack([o, z, z], -1), np.stack([z, c, -s], -1),
                     np.stack([z, s, c], -1)], -2)


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones_like(a), np.zeros_like(a)
    return np.stack([np.stack([c, z, s], -1), np.stack([z, o, z], -1),
                     np.stack([-s, z, c], -1)], -2)


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones_like(a), np.zeros_like(a)
    return np.stack([np.stack([c, -s, z], -1), np.stack([s, c, z], -1),
                     np.stack([z, z, o], -1)], -2)


@dataclass(frozen=True)
class Loop:
    """The closed loop: `fps` frames a second, `frames` frames a loop;
    translation amplitudes (m) and periods (s) along world x, y, z; rotation
    amplitudes (degrees) and periods (s) about the left camera's z, y, x
    axes."""
    fps: float
    frames: int
    lin_amp: tuple
    lin_period: tuple
    ang_amp_deg: tuple
    ang_period: tuple

    @property
    def seconds(self) -> float:
        return self.frames / self.fps

    def check(self):
        for p in tuple(self.lin_period) + tuple(self.ang_period):
            k = self.seconds / p
            if abs(k - round(k)) > 1e-9:
                raise ValueError(f"period {p} s does not divide the "
                                 f"{self.seconds} s loop")

    def position(self, t):
        """(..., 3) body position at times t (s)."""
        t = np.asarray(t, float)[..., None]
        a = np.asarray(self.lin_amp)
        return a * np.sin(2 * np.pi * t / np.asarray(self.lin_period))

    def angles(self, t):
        t = np.asarray(t, float)[..., None]
        a = np.deg2rad(np.asarray(self.ang_amp_deg))
        return a * np.sin(2 * np.pi * t / np.asarray(self.ang_period))

    def R_W_C(self, t):
        a = self.angles(t)
        return R_LEVEL @ _rz(a[..., 0]) @ _ry(a[..., 1]) @ _rx(a[..., 2])

    def poses(self, t, rig: Rig):
        """(..., 4, 4) body poses T_W_B at times t."""
        t = np.asarray(t, float)
        T = np.zeros(t.shape + (4, 4))
        T[..., :3, :3] = self.R_W_C(t) @ rig.T_B_C[0][:3, :3].T
        T[..., :3, 3] = self.position(t)
        T[..., 3, 3] = 1.0
        return T

    def velocity(self, t, h: float = 1e-5):
        return (self.position(np.asarray(t) + h)
                - self.position(np.asarray(t) - h)) / (2 * h)

    def imu(self, t, rig: Rig, h: float = 1e-4):
        """Ideal body-frame angular rate (rad/s) and specific force (m/s^2)
        at times t, by central differences."""
        t = np.asarray(t, float)
        R = self.poses(t, rig)[..., :3, :3]
        Rp = self.poses(t + h, rig)[..., :3, :3]
        Rm = self.poses(t - h, rig)[..., :3, :3]
        Wb = np.swapaxes(R, -1, -2) @ (Rp - Rm) / (2 * h)
        gyro = np.stack([Wb[..., 2, 1], Wb[..., 0, 2], Wb[..., 1, 0]], -1)
        acc_w = (self.position(t + h) - 2 * self.position(t)
                 + self.position(t - h)) / (h * h)
        accel = (np.swapaxes(R, -1, -2) @ (acc_w - GRAVITY_W)[..., None])[..., 0]
        return gyro, accel


def loop_from_traffic(traffic: dict) -> Loop:
    lp = Loop(fps=float(traffic["fps"]), frames=int(traffic["loop_frames"]),
              lin_amp=tuple(traffic["lin_amp_m"]),
              lin_period=tuple(traffic["lin_period_s"]),
              ang_amp_deg=tuple(traffic["ang_amp_deg"]),
              ang_period=tuple(traffic["ang_period_s"]))
    lp.check()
    return lp


def start_frame(stream: int, streams: int, loop_frames: int) -> int:
    """The loop frame stream `stream` of `streams` starts at."""
    return stream * loop_frames // streams


# ---------------------------------------------------------------------------
# The plane and the renderer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Plane:
    """A point X0 on the plane, its unit normal n and texture axes ex, ey
    (world, float64)."""
    X0: np.ndarray
    n: np.ndarray
    ex: np.ndarray
    ey: np.ndarray


def make_plane(loop: Loop, rig: Rig, dist: float) -> Plane:
    T = loop.poses(0.0, rig) @ rig.T_B_C[0]
    R, c = T[:3, :3], T[:3, 3]
    return Plane(c + dist * R[:, 2], R[:, 2].copy(), R[:, 0].copy(),
                 R[:, 1].copy())


def make_texture(seed: int, device, size: int = TEX_SIZE,
                 octaves=OCTAVES) -> torch.Tensor:
    """(size, size) float32 texture on `device` from `seed`: a sum of
    weighted bicubic upscales of uniform noise drawn on the device, plus
    40."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    tex = torch.full((size, size), 40.0, device=device)
    for w, n in octaves:
        noise = torch.rand((1, 1, n, n), generator=g, device=device)
        tex += w * F.interpolate(noise, size=(size, size), mode="bicubic",
                                 align_corners=False)[0, 0]
    return tex


def _reflect(i, n: int):
    """OpenCV's BORDER_REFLECT: fedcba|abcdef|fedcba."""
    period = 2 * n
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - 1 - i, i)


def remap_bilinear(tex, mx, my):
    Ht, Wt = tex.shape
    x0, y0 = torch.floor(mx), torch.floor(my)
    fx, fy = mx - x0, my - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    xa, xb = _reflect(x0, Wt), _reflect(x0 + 1, Wt)
    ya, yb = _reflect(y0, Ht), _reflect(y0 + 1, Ht)
    top = tex[ya, xa] * (1 - fx) + tex[ya, xb] * fx
    bot = tex[yb, xa] * (1 - fx) + tex[yb, xb] * fx
    return top * (1 - fy) + bot * fy


class Renderer:
    """Renders the plane through `rig` on `device`: each pixel's ray (the
    camera model's unprojection, made once) rotated into the world by the
    body pose and the camera's extrinsics and intersected with the plane.
    Between the angles FADE[0] and FADE[1] from the plane's normal the image
    fades to the texture's mean and beyond FADE[1] it is that constant, so
    no corner is born where the texture aliases."""

    def __init__(self, rig: Rig, plane: Plane, device):
        self.rig, self.plane, self.device = rig, plane, device
        h, w = rig.shape
        v, u = torch.meshgrid(torch.arange(h, dtype=torch.float64,
                                           device=device),
                              torch.arange(w, dtype=torch.float64,
                                           device=device), indexing="ij")
        uv = torch.stack([u, v], -1)
        self.rays = []
        for cam in (0, 1):
            p = torch.tensor(rig.params[cam], dtype=torch.float64,
                             device=device)
            xy = unproject(p, uv)
            d = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
            self.rays.append((d / torch.linalg.vector_norm(
                d, dim=-1, keepdim=True)).to(torch.float32))
        f32 = dict(dtype=torch.float32, device=device)
        self.n = torch.tensor(plane.n, **f32)
        self.X0 = torch.tensor(plane.X0, **f32)
        self.ex = torch.tensor(plane.ex, **f32)
        self.ey = torch.tensor(plane.ey, **f32)
        self.scale = TEX_PER_M * 458.0

    def render(self, tex, T_W_B: np.ndarray):
        """(left, right) float32 images for body pose T_W_B (4x4)."""
        out = []
        c_min, s_min = math.cos(FADE[1]), math.sin(FADE[1])
        fill = tex.mean()
        n = self.n
        for cam in (0, 1):
            T = torch.tensor(T_W_B @ self.rig.T_B_C[cam], dtype=torch.float32,
                             device=self.device)
            d = self.rays[cam] @ T[:3, :3].T
            cos_t = d @ n
            ramp = torch.clamp((torch.acos(torch.clamp(cos_t, -1.0, 1.0))
                                - FADE[0]) / (FADE[1] - FADE[0]), 0.0, 1.0)
            perp = d - cos_t[..., None] * n
            perp = perp / torch.clamp(torch.linalg.vector_norm(
                perp, dim=-1, keepdim=True), min=1e-9)
            d = torch.where((cos_t < c_min)[..., None],
                            c_min * n + s_min * perp, d)
            o = T[:3, 3]
            X = o + (((self.X0 - o) @ n) / (d @ n))[..., None] * d
            mx = ((X - self.X0) @ self.ex) * self.scale + TEX_OFFSET
            my = ((X - self.X0) @ self.ey) * self.scale + TEX_OFFSET
            out.append(torch.lerp(remap_bilinear(tex, mx, my), fill,
                                  ramp * ramp * (3.0 - 2.0 * ramp)))
        return tuple(out)


def to_uint8(img):
    """A rendered image as the 8-bit frame a camera's PNG would hold."""
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def render_loop(rnd: Renderer, loop: Loop, tex, pinned: bool):
    """A loop's (left, right) uint8 frames, (F, H, W) each, on the host
    (pinned when the renderer is on a card)."""
    H, W = rnd.rig.shape
    F_ = loop.frames
    out = [torch.empty((F_, H, W), dtype=torch.uint8, pin_memory=pinned)
           for _ in range(2)]
    T = loop.poses(np.arange(F_) / loop.fps, rnd.rig)
    for j in range(F_):
        left, right = rnd.render(tex, T[j])
        out[0][j].copy_(to_uint8(left), non_blocking=pinned)
        out[1][j].copy_(to_uint8(right), non_blocking=pinned)
    if pinned:
        torch.cuda.synchronize(rnd.device)
    return out


# ---------------------------------------------------------------------------
# IMU
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Imu:
    """One loop of IMU samples: sample m stamped (m + 1) / rate, holding the
    rate over ((m) / rate, (m + 1) / rate] at its midpoint, plus constant
    biases and white noise; and the static head's samples."""
    gyro: np.ndarray      # (loop samples, 3)
    accel: np.ndarray
    head_gyro: np.ndarray  # (head samples, 3), at rest at the start pose
    head_accel: np.ndarray
    rate: float


def make_imu(loop: Loop, rig: Rig, imu_cfg: dict, rng: np.random.Generator,
             start_t: float, head_s: float) -> Imu:
    rate = float(imu_cfg["rate_hz"])
    n = int(round(loop.seconds * rate))
    mid = (np.arange(n) + 0.5) / rate
    gyro, accel = loop.imu(mid, rig)
    bg = np.asarray(imu_cfg["gyro_bias"], float)
    ba = np.asarray(imu_cfg["accel_bias"], float)
    sg = float(imu_cfg["gyroscope_noise_density"]) * math.sqrt(rate)
    sa = float(imu_cfg["accelerometer_noise_density"]) * math.sqrt(rate)
    gyro = gyro + bg + rng.normal(0.0, sg, gyro.shape)
    accel = accel + ba + rng.normal(0.0, sa, accel.shape)
    m = int(round(head_s * rate))
    R0 = loop.poses(start_t, rig)[:3, :3]
    still = R0.T @ -GRAVITY_W
    head_g = bg + rng.normal(0.0, sg, (m, 3))
    head_a = still + ba + rng.normal(0.0, sa, (m, 3))
    f32 = np.float32
    return Imu(gyro.astype(f32), accel.astype(f32), head_g.astype(f32),
               head_a.astype(f32), rate)


def frame_imu_buffers(imu: Imu, loop: Loop, buf: int):
    """Per loop frame j the masked buffer the command line builds for the
    interval (t_{j-1}, t_j]: gyro (F, buf, 3), accel, dts (F, buf), mask.
    The loop repeats, so frame 0 holds the previous loop's last samples."""
    per = int(round(imu.rate / loop.fps))
    if per * loop.frames != len(imu.gyro) or per > buf:
        raise ValueError("the IMU rate must be a whole multiple of the frame "
                         "rate, with at most `buf` samples a frame")
    F_ = loop.frames
    idx = (np.arange(F_)[:, None] * per - per + np.arange(per)[None, :]) \
        % len(imu.gyro)
    gyro = np.zeros((F_, buf, 3), np.float32)
    accel = np.zeros((F_, buf, 3), np.float32)
    dts = np.zeros((F_, buf), np.float32)
    mask = np.zeros((F_, buf), bool)
    gyro[:, :per] = imu.gyro[idx]
    accel[:, :per] = imu.accel[idx]
    dts[:, :per] = np.float32(1.0 / imu.rate)
    mask[:, :per] = True
    return gyro, accel, dts, mask
