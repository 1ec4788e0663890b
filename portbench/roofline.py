"""The least time the KLT kernel (K1, csrc/klt_bidir.cu's
klt_bidir_kernel) could take for a frame, from the frame's shapes.

The arithmetic of chip_smoke.bound_ms, kept here: the larger of the bytes
the call must move at the HBM rate and its fp32 operations at the fp32
rate (NVIDIA H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s outside the
tensor cores, at a 700 W limit). Operations per pattern point are counted
from the kernel's source (building one template; one Gauss-Newton step).

What a frame needs, counted from below, so the share can never pass 100 %:
a frame makes two K1 launches, the temporal pass over both cameras' live
tracks (2 n_prev features, n_prev the previous frame's live count) and the
stereo pass over the candidates, of which at least the births (n_alive -
n_tracked) were tracked. Each feature needs, in each direction and at each
level, one template and at least one Gauss-Newton step. Bytes: each
feature's position and warp in and out (the pixels its patches read
overlap between features, so they are not counted).
"""

from __future__ import annotations

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PATTERN_POINTS = 256
TEMPLATE_OPS = 68
ITER_OPS = 19
FEATURE_BYTES = 2 * (8 + 16) + 1


def k1_frame_bound_s(levels: int, n_prev: int, n_alive: int,
                     n_tracked: int) -> float:
    features = 2 * n_prev + max(n_alive - n_tracked, 0)
    per_feature = 2 * levels * PATTERN_POINTS * (TEMPLATE_OPS + ITER_OPS)
    t_ops = features * per_feature / PEAK_FP32
    t_bytes = features * FEATURE_BYTES / PEAK_BYTES
    return max(t_ops, t_bytes)
