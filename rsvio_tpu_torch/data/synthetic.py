"""Synthetic stereo(+IMU) scenes, rendered without OpenCV.

Port of rsvio_tpu/data/synthetic.py: 6-DoF sinusoid trajectories with
exact poses and IMU (midpoint-sampled angular rate and specific force,
optional biases and white noise), depth-structured worlds of textured
planes ray-cast with occlusion, photometric gain / bias drift, a moving
occluder, and the accuracy matrix's four canned scenes. The world is z-up
with gravity (0, 0, -9.81); a level camera is ``R_LEVEL``.

What differs from the JAX package's module:
  * ``make_texture`` upsamples its noise octaves with bicubic
    ``torch.nn.functional.interpolate`` (a = -0.75, half-pixel centres,
    clamped borders) where JAX calls ``cv2.resize(INTER_CUBIC)``.
  * ``render_camera`` ray-casts on the device the textures live on, in
    float64, and samples each plane's texture bilinearly with clamped
    (replicated) borders in float32, where JAX ray-casts in numpy and
    calls ``cv2.remap(INTER_LINEAR, BORDER_REPLICATE)``, which quantizes
    the sample position to 1/32 px. Frames are (H, W) float32 tensors.
  * Scene builders and ``make_texture`` take a ``device`` (default
    "cuda"); ``generate_sequence`` renders there.
Trajectories and IMU sampling are host numpy, copied from JAX's module.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

GRAVITY_W = np.array([0.0, 0.0, -9.81], np.float64)

# Level camera attitude in the z-up world: body/camera x -> world x (right),
# y (down) -> world -z, z (forward/optical axis) -> world +y.
R_LEVEL = np.array([[1.0, 0.0, 0.0],
                    [0.0, 0.0, 1.0],
                    [0.0, -1.0, 0.0]], np.float64)  # columns are body axes


def make_texture(size: int = 1024, seed: int = 0,
                 scales=((90.0, 24), (60.0, 96), (40.0, 256)),
                 offset: float = 40.0, device="cuda") -> torch.Tensor:
    """(size, size) float32 multi-scale smooth random texture on `device`:
    bicubic upscales of uniform noise (the JAX recipe's draws), weighted,
    plus offset, clipped to [0, 255]."""
    rng = np.random.default_rng(seed)
    tex = torch.zeros((size, size), dtype=torch.float32, device=device)
    for w, n in scales:
        noise = torch.from_numpy(rng.uniform(0, 1, (n, n)).astype(np.float32))
        up = F.interpolate(noise.to(device)[None, None], size=(size, size),
                           mode="bicubic", align_corners=False)[0, 0]
        tex = tex + w * up
    return torch.clamp(tex + offset, 0.0, 255.0)


@dataclasses.dataclass(frozen=True)
class Plane:
    """A textured rectangle in the world: origin (3,), unit in-plane axes
    a1 / a2 (3,) (texture s / t), extent (s_min, s_max, t_min, t_max) in
    m, tex (Ht, Wt) float32 tensor, tex_scale texels a metre, motion an
    optional t (s) -> (3,) offset of the origin (a moving occluder)."""
    origin: np.ndarray
    a1: np.ndarray
    a2: np.ndarray
    extent: tuple
    tex: torch.Tensor
    tex_scale: float = 100.0
    motion: Optional[Callable[[float], np.ndarray]] = None

    def origin_at(self, t: float) -> np.ndarray:
        if self.motion is None:
            return self.origin
        return self.origin + np.asarray(self.motion(t), np.float64)


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    planes: Sequence[Plane]
    H: int = 480
    W: int = 752
    fx: float = 458.0
    fy: float = 458.0
    cx: float = 376.0
    cy: float = 240.0
    baseline: float = 0.11  # right camera at +x in the body frame
    # Photometric drift: frame intensity = gain(t) * I + bias(t)
    gain_fn: Optional[Callable[[float], float]] = None
    bias_fn: Optional[Callable[[float], float]] = None


def remap_replicate(tex, mx, my):
    """Bilinear sample of tex (Ht, Wt) at float32 maps mx, my, border
    pixels replicated."""
    Ht, Wt = tex.shape
    x0, y0 = torch.floor(mx), torch.floor(my)
    fx, fy = mx - x0, my - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    xa, xb = x0.clamp(0, Wt - 1), (x0 + 1).clamp(0, Wt - 1)
    ya, yb = y0.clamp(0, Ht - 1), (y0 + 1).clamp(0, Ht - 1)
    top = tex[ya, xa] * (1 - fx) + tex[ya, xb] * fx
    bot = tex[yb, xa] * (1 - fx) + tex[yb, xb] * fx
    return top * (1 - fy) + bot * fy


def render_camera(scene: SceneConfig, T_W_C: np.ndarray,
                  t: float = 0.0) -> torch.Tensor:
    """Ray-cast all planes from camera pose T_W_C (4x4, host); the nearest
    positive hit wins (occlusion). Returns (H, W) float32 on the planes'
    device."""
    H, W = scene.H, scene.W
    dev = scene.planes[0].tex.device
    f64 = dict(dtype=torch.float64, device=dev)
    v, u = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                          indexing="ij")
    # Ray with z == 1: the plane-hit parameter is the camera depth.
    d_cam = torch.stack([(u - scene.cx) / scene.fx, (v - scene.cy) / scene.fy,
                         torch.ones_like(u)], dim=-1)          # (H,W,3)
    R = torch.as_tensor(np.asarray(T_W_C[:3, :3], np.float64), **f64)
    c = np.asarray(T_W_C[:3, 3], np.float64)
    d_w = d_cam @ R.T
    depth = torch.full((H, W), torch.inf, **f64)
    img = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for plane in scene.planes:
        o = plane.origin_at(t)
        n = np.cross(plane.a1, plane.a2)
        denom = d_w @ torch.as_tensor(n, **f64)
        t_hit = float(n @ (o - c)) / denom
        t_hit = torch.where(torch.isfinite(t_hit), t_hit,
                            torch.full_like(t_hit, -1.0))
        rel = torch.as_tensor(c - o, **f64) + t_hit[..., None] * d_w
        s = rel @ torch.as_tensor(plane.a1, **f64)
        tt = rel @ torch.as_tensor(plane.a2, **f64)
        s0, s1, t0, t1 = plane.extent
        hit = ((t_hit > 1e-6) & (s >= s0) & (s <= s1) & (tt >= t0)
               & (tt <= t1) & (t_hit < depth))
        Ht, Wt = plane.tex.shape
        mx = torch.clamp((s - s0) * plane.tex_scale, 0, Wt - 1.001)
        my = torch.clamp((tt - t0) * plane.tex_scale, 0, Ht - 1.001)
        vals = remap_replicate(plane.tex, mx.to(torch.float32),
                               my.to(torch.float32))
        img = torch.where(hit, vals, img)
        depth = torch.where(hit, t_hit, depth)
    if scene.gain_fn is not None:
        img = img * scene.gain_fn(t)
    if scene.bias_fn is not None:
        img = img + scene.bias_fn(t)
    return torch.clamp(img, 0.0, 255.0)


def render_stereo(scene: SceneConfig, T_W_B: np.ndarray, t: float = 0.0):
    """(left, right) with the right camera at +baseline along body x (the
    rig T_B_Cl = I)."""
    T_W_Cr = np.array(T_W_B, np.float64, copy=True)
    T_W_Cr[:3, 3] = T_W_B[:3, 3] + T_W_B[:3, :3] @ np.array(
        [scene.baseline, 0.0, 0.0])
    return (render_camera(scene, T_W_B, t),
            render_camera(scene, T_W_Cr, t))


# ---------------------------------------------------------------------------
# Trajectories (host numpy)
# ---------------------------------------------------------------------------

def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """6-DoF body trajectory: position pos(t) and attitude R_W_B(t) =
    R0 @ Rz(yaw) @ Ry(pitch) @ Rx(roll), the angles ang_fn(t) = (yaw,
    pitch, roll). Exact poses; IMU by midpoint finite differences."""
    pos_fn: Callable[[float], np.ndarray]
    ang_fn: Callable[[float], np.ndarray]
    R0: np.ndarray = dataclasses.field(
        default_factory=lambda: R_LEVEL.copy())

    def pose(self, t: float) -> np.ndarray:
        y, p, r = self.ang_fn(t)
        T = np.eye(4)
        T[:3, :3] = self.R0 @ _rot_z(y) @ _rot_y(p) @ _rot_x(r)
        T[:3, 3] = self.pos_fn(t)
        return T

    def sample_imu(self, t0: float, t1: float, rate: float = 200.0,
                   gyro_bias=None, accel_bias=None, noise_rng=None,
                   gyro_noise: float = 0.0, accel_noise: float = 0.0):
        """Body-frame IMU samples on (t0, t1]: midpoint angular rate and
        specific force (gravity subtracted), plus optional constant biases
        and white noise (densities times sqrt(rate)). Returns (ts (S,),
        gyro (S,3), accel (S,3), dts (S,)), float32 but ts."""
        dt = 1.0 / rate
        n = max(int(round((t1 - t0) * rate)), 1)
        ts = t0 + dt * (np.arange(n) + 1.0)
        mid = ts - 0.5 * dt
        h = 1e-4
        gyro = np.zeros((n, 3))
        accel = np.zeros((n, 3))
        for i, tm in enumerate(mid):
            R = self.pose(tm)[:3, :3]
            Rp = self.pose(tm + h)[:3, :3]
            Rm = self.pose(tm - h)[:3, :3]
            Wb = R.T @ (Rp - Rm) / (2 * h)        # vee(R^T dR/dt)
            gyro[i] = np.array([Wb[2, 1], Wb[0, 2], Wb[1, 0]])
            a_w = (self.pos_fn(tm + h) - 2 * self.pos_fn(tm)
                   + self.pos_fn(tm - h)) / (h * h)
            accel[i] = R.T @ (a_w - GRAVITY_W)
        if gyro_bias is not None:
            gyro = gyro + np.asarray(gyro_bias)
        if accel_bias is not None:
            accel = accel + np.asarray(accel_bias)
        if noise_rng is not None:
            sqrt_rate = np.sqrt(rate)
            gyro = gyro + noise_rng.normal(
                0.0, gyro_noise * sqrt_rate, (n, 3))
            accel = accel + noise_rng.normal(
                0.0, accel_noise * sqrt_rate, (n, 3))
        return ts, gyro.astype(np.float32), accel.astype(np.float32), \
            np.full(n, dt, np.float32)


def tilted(traj: Trajectory, roll_deg: float = 0.0,
           pitch_deg: float = 0.0) -> Trajectory:
    """The same trajectory flown with a constant extra body tilt (a
    non-level start for the gravity alignment)."""
    R_tilt = _rot_y(np.deg2rad(pitch_deg)) @ _rot_x(np.deg2rad(roll_deg))
    return dataclasses.replace(traj, R0=traj.R0 @ R_tilt)


# ---------------------------------------------------------------------------
# Canned scenes (the accuracy matrix's fixtures)
# ---------------------------------------------------------------------------

def _frontal_plane(z_forward: float, half_w: float, half_h: float,
                   seed: int, tex_scale: float = 100.0,
                   tex_size: int = 1024, motion=None,
                   device="cuda") -> Plane:
    """A plane facing the level camera at forward distance z_forward
    (world +y), x in [-half_w, half_w], z in [-half_h, half_h]."""
    return Plane(
        origin=np.array([-half_w, z_forward, -half_h], np.float64),
        a1=np.array([1.0, 0.0, 0.0]),
        a2=np.array([0.0, 0.0, 1.0]),
        extent=(0.0, 2 * half_w, 0.0, 2 * half_h),
        tex=make_texture(tex_size, seed=seed, device=device),
        tex_scale=tex_scale, motion=motion)


def _intrinsics(H, W):
    """EuRoC-like FOV at any resolution (focal scales with width)."""
    f = 458.0 * W / 752.0
    return dict(H=H, W=W, fx=f, fy=f, cx=W / 2, cy=H / 2)


def scene_easy_plane(H=480, W=752, seed=0, device="cuda") -> SceneConfig:
    """One fronto-parallel plane 5 m ahead."""
    return SceneConfig(planes=[_frontal_plane(5.0, 12.0, 8.0, seed,
                                              device=device)],
                       **_intrinsics(H, W))


def scene_depth_structured(H=480, W=752, seed=1,
                           device="cuda") -> SceneConfig:
    """Corridor-like geometry: far backdrop, near and mid facades, ground
    plane; depth ~3-14 m."""
    planes = [
        _frontal_plane(14.0, 30.0, 16.0, seed, tex_scale=40.0,
                       device=device),
        Plane(origin=np.array([-8.0, 4.0, -5.0]),
              a1=np.array([1.0, 0.0, 0.0]), a2=np.array([0.0, 0.0, 1.0]),
              extent=(0.0, 6.5, 0.0, 10.0),
              tex=make_texture(768, seed=seed + 1, device=device),
              tex_scale=120.0),
        Plane(origin=np.array([1.5, 8.0, -6.0]),
              a1=np.array([1.0, 0.0, 0.0]), a2=np.array([0.0, 0.0, 1.0]),
              extent=(0.0, 12.0, 0.0, 12.0),
              tex=make_texture(768, seed=seed + 2, device=device),
              tex_scale=80.0),
        Plane(origin=np.array([-15.0, 0.5, -1.5]),
              a1=np.array([1.0, 0.0, 0.0]), a2=np.array([0.0, 1.0, 0.0]),
              extent=(0.0, 30.0, 0.0, 16.0),
              tex=make_texture(1024, seed=seed + 3, device=device),
              tex_scale=60.0),
    ]
    return SceneConfig(planes=planes, **_intrinsics(H, W))


def scene_photometric(H=480, W=752, seed=2, gain_amp=0.25, gain_period=3.0,
                      bias_amp=12.0, bias_period=4.1,
                      device="cuda") -> SceneConfig:
    """Depth-structured geometry with sinusoidal exposure gain / bias."""
    base = scene_depth_structured(H, W, seed, device=device)
    return dataclasses.replace(
        base,
        gain_fn=lambda t: 1.0 + gain_amp * np.sin(2 * np.pi * t / gain_period),
        bias_fn=lambda t: bias_amp * np.sin(2 * np.pi * t / bias_period))


def scene_occlusion(H=480, W=752, seed=3, speed=0.45,
                    device="cuda") -> SceneConfig:
    """Depth-structured geometry with a moving textured quad 2 m ahead
    sweeping across the view."""
    base = scene_depth_structured(H, W, seed, device=device)
    occluder = Plane(
        origin=np.array([-2.4, 2.0, -0.9]),
        a1=np.array([1.0, 0.0, 0.0]), a2=np.array([0.0, 0.0, 1.0]),
        extent=(0.0, 1.8, 0.0, 1.8),
        tex=make_texture(256, seed=seed + 9, scales=((70.0, 16), (50.0, 64)),
                         device=device),
        tex_scale=140.0,
        motion=lambda t: np.array([speed * t, 0.0, 0.0]))
    return dataclasses.replace(base, planes=list(base.planes) + [occluder])


def traj_forward(speed=0.25) -> Trajectory:
    """Pure lateral translation."""
    return Trajectory(
        pos_fn=lambda t: np.array([speed * t, 0.0, 0.0]),
        ang_fn=lambda t: np.zeros(3))


def traj_6dof(lin_amp=(0.9, 0.35, 0.25), lin_period=(7.0, 5.3, 4.3),
              ang_amp_deg=(8.0, 5.0, 4.0),
              ang_period=(6.1, 4.7, 5.9)) -> Trajectory:
    """Simultaneous 3-axis sinusoidal translation and rotation."""
    la = np.asarray(lin_amp)
    lp = np.asarray(lin_period)
    aa = np.deg2rad(ang_amp_deg)
    ap = np.asarray(ang_period)

    def pos(t):
        return la * np.sin(2 * np.pi * t / lp)

    def ang(t):
        return aa * np.sin(2 * np.pi * t / ap)

    return Trajectory(pos_fn=pos, ang_fn=ang)


MATRIX_SCENES = {
    "easy_plane": (scene_easy_plane, traj_forward),
    "depth_6dof": (scene_depth_structured, traj_6dof),
    "photometric_6dof": (scene_photometric, traj_6dof),
    "occlusion_6dof": (scene_occlusion, traj_6dof),
}


def generate_sequence(scene: SceneConfig, traj: Trajectory, n_frames: int,
                      fps: float = 20.0, imu_rate: float = 0.0,
                      imu_kwargs: Optional[dict] = None):
    """Render a whole sequence on the scene's device.

    Returns a dict: ts (s), frames [(left, right) tensors], gt_T_W_B
    (n,4,4); with imu_rate > 0 also imu_ts / gyro / accel / imu_dts (flat
    host arrays over the whole sequence)."""
    dt = 1.0 / fps
    ts = np.arange(n_frames) * dt
    frames = []
    poses = np.zeros((n_frames, 4, 4))
    for i, t in enumerate(ts):
        T = traj.pose(t)
        poses[i] = T
        frames.append(render_stereo(scene, T, t))
    out = {"ts": ts, "frames": frames, "gt_T_W_B": poses}
    if imu_rate > 0:
        kw = imu_kwargs or {}
        its, gy, ac, idts = traj.sample_imu(
            ts[0] - dt, ts[-1], rate=imu_rate, **kw)
        out.update(imu_ts=its, gyro=gy, accel=ac, imu_dts=idts)
    return out
