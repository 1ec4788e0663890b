// Inverse-compositional KLT for Hopper (sm_90a): the fused bidirectional
// coarse-to-fine pass (klt_bidir_launch) and the one-level pass
// (klt_level_launch), each in a translation (2-dof) and an SE2 rotation
// (3-dof) variant, all built from one templated level body.
//
// Replaces the TPU kernels of rsvio_tpu/ops/pallas/klt_kernel.py:
//   - track_bidirectional_pyramid / _klt_bidir_kernel (one launch tracks
//     every feature forward over all pyramid levels, backward from the
//     forward result, and applies the return-distance gate), with
//     with_rotation False or True;
//   - track_level / _klt_level_kernel (one level, one direction).
// Both compute what the TPU kernel's _level_pass computes: a dense 16x16
// unit-spacing patch, bilinear samples and bilinearly interpolated
// central-difference gradients, LSSD mean normalization with the corrected
// Jacobian (or raw SSD), a 2x2 (translation) or 3x3 (SE2) Gauss-Newton
// system plus fixed Levenberg damping inverted by adjugate, per-feature
// freeze on convergence or failure, and (fused pass) the strict /
// coarse-tolerant level policy.
//
// Design. One thread block per feature, one thread per pattern point (256).
// Every Gauss-Newton iteration loads the window around the current position
// from the level image in global memory into shared memory, with every
// pixel coordinate clamped to the image: that is the edge replication the
// TPU kernel gets from padding its images. Translation uses a 20x20 window
// (center 9, pattern base 1); rotation a 25x25 one (center 12, base 4), as
// the TPU kernel does. The rotation variant samples each pattern point
// bilinearly at its own rotated coordinate center + u + (R(theta)-I)u + frac
// with u = (c-8, r-8), with the hat weights the TPU kernel uses; a tap that
// falls outside the window (only for a caller's start angle beyond the
// theta gate) is read from the image with clamped coordinates, so sampling
// is exact for every angle. The template and its gradients stay unrotated,
// as in the TPU kernel. The per-feature sums (mean, mean gradient, Hessian,
// increments) are warp shuffles plus an 8-entry shared-memory pass, summed
// in a fixed order so that every thread of the block holds the same value
// and takes the same branch. A feature leaves its Gauss-Newton loop as soon
// as it converges or fails, which gives the same result as the TPU's
// per-block loop with per-feature freeze. Bilinear interpolation is done by
// hand in fp32 (no texture filtering: its fixed-point weights would break
// parity with the reference).
//
// What bounds it on the H100: the latency of a chain of dependent steps per
// feature (window load -> two block reductions -> position update), up to
// 2 directions x levels x (1 + max_iterations) times. At 512 features the
// images are L2-resident and the kernel moves a few MB, so it is neither
// bandwidth- nor FLOP-bound; the design keeps all 256 threads of a block on
// one feature so each step of the chain is as short as possible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kPatch = 16;
constexpr int kThreads = kPatch * kPatch;
constexpr int kWarps = kThreads / 32;
constexpr int kWinMax = 25;
constexpr int kMaxSums = 6;
constexpr float kMargin = 2.0f;
constexpr float kMinMean = 1e-3f;
constexpr float kMinGradEnergy = 1e-4f;
constexpr float kMinGradEnergySsd = 1e-4f * 255.0f * 255.0f;
constexpr float kDetEps = 1e-12f;
constexpr float kNpts = 256.0f;
constexpr float kMaxThetaSq = 0.12f;   // theta step gate (TPU: _MAX_THETA_SQ)

// Window geometry per variant: edge, index of floor(position), pattern base.
template <bool kRot>
struct Geom {
  static constexpr int E = kRot ? 25 : 20;
  static constexpr int C = kRot ? 12 : 9;
  static constexpr int B = kRot ? 4 : 1;
};

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long off[kMaxLevels];
  float s[kMaxLevels];      // full-res -> level scale
  float inv_s[kMaxLevels];  // level -> full-res scale
};

struct Params {
  int max_iterations;
  float conv_thresh_sq;
  float bidir_thresh_sq;
  int ssd;
  float lm_lambda;
  int coarse_tolerant;
};

__device__ __forceinline__ bool in_margin(float x, float y, int h, int w) {
  return x >= kMargin && y >= kMargin && x <= (float)(w - 1) - kMargin &&
         y <= (float)(h - 1) - kMargin;
}

__device__ __forceinline__ float lerp4(float v00, float v01, float v10,
                                       float v11, float fx, float fy) {
  float top = v00 * (1.0f - fx) + v01 * fx;
  float bot = v10 * (1.0f - fx) + v11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

// Image coordinate of window index 0 along one axis: floor(p) - center.
// Non-finite or far-away positions get some in-image window; such a feature
// fails its margin test, so the values are never used.
__device__ __forceinline__ int window_base(float p, int center) {
  return (int)fminf(fmaxf(floorf(p), -1e6f), 1e6f) - center;
}

__device__ __forceinline__ float clamped_pixel(const float* img, int h, int w,
                                               int y, int x) {
  y = min(max(y, 0), h - 1);
  x = min(max(x, 0), w - 1);
  return img[(long long)y * w + x];
}

// Loads the E x E window whose index (C, C) is floor(p), clamping each
// pixel coordinate into the image.
template <int E, int C>
__device__ void load_window(float* win, const float* img, int h, int w,
                            float px, float py, int tid) {
  const int bx = window_base(px, C);
  const int by = window_base(py, C);
  for (int k = tid; k < E * E; k += kThreads) {
    const int j = k / E;
    win[k] = clamped_pixel(img, h, w, by + j, bx + (k - j * E));
  }
}

// Block-wide sums of K values. Every thread returns the same totals.
template <int K>
__device__ __forceinline__ void block_sum(float* v, float* red, int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[k * kWarps + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[k * kWarps + i];
    v[k] = s;
  }
  __syncthreads();
}

// Hat (bilinear) weight max(0, 1 - |d - k|); NaN stays NaN, as jnp.maximum.
__device__ __forceinline__ float hat(float d, float k) {
  const float t = 1.0f - fabsf(d - k);
  return t < 0.0f ? 0.0f : t;
}

// Bilinear sample of pattern point (r, c) displaced by (dx, dy) window
// pixels from its unrotated tap: the TPU kernel's _rot_sample, whose hat
// weights are nonzero only at floor(d) and floor(d) + 1. Taps inside the
// window come from shared memory, others from the image (clamped).
template <int E, int B, int C>
__device__ float rot_sample(const float* win, const float* img, int h, int w,
                            float px, float py, float dx, float dy, int r,
                            int c) {
  const float kx = fminf(fmaxf(floorf(dx), -64.0f), 64.0f);
  const float ky = fminf(fmaxf(floorf(dy), -64.0f), 64.0f);
  const float wx0 = hat(dx, kx), wx1 = hat(dx, kx + 1.0f);
  const float wy0 = hat(dy, ky), wy1 = hat(dy, ky + 1.0f);
  const int i0 = B + c + (int)kx;
  const int j0 = B + r + (int)ky;
  float v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = j0 + (t >> 1);
    const int i = i0 + (t & 1);
    if (j >= 0 && j < E && i >= 0 && i < E) {
      v[t] = win[j * E + i];
    } else {
      v[t] = clamped_pixel(img, h, w, window_base(py, C) + j,
                           window_base(px, C) + i);
    }
  }
  const float row0 = wx0 * v[0] + wx1 * v[1];
  const float row1 = wx0 * v[2] + wx1 * v[3];
  return wy0 * row0 + wy1 * row1;
}

// One pyramid level of IC-KLT for the block's feature: template at (tx, ty)
// in `src`, Gauss-Newton from (px, py) and angle th in `dst` (level
// coordinates). Returns the level's ok flag; (px, py, th) hold the final
// warp (th is only changed by the rotation variant).
template <bool kRot>
__device__ __forceinline__ bool level_pass(const float* src, const float* dst, int h, int w,
                           float tx, float ty, float& px, float& py,
                           float& th, const Params& P, float* win, float* red,
                           int tid) {
  constexpr int E = Geom<kRot>::E;
  constexpr int C = Geom<kRot>::C;
  constexpr int B = Geom<kRot>::B;
  constexpr int NS = kRot ? 4 : 3;    // template sums
  constexpr int NH = kRot ? 6 : 3;    // Hessian entries
  constexpr int ND = kRot ? 3 : 2;    // degrees of freedom
  const int r = tid / kPatch;
  const int c = tid - r * kPatch;
  const float xc = (float)(c - 8);    // pattern offset from the tracked point
  const float yc = (float)(r - 8);
  const bool ssd = P.ssd != 0;
#define WV(dy, dx) win[(B + r + (dy)) * E + (B + c + (dx))]

  // ---- template (source image, unrotated) ----
  __syncthreads();
  load_window<E, C>(win, src, h, w, tx, ty, tid);
  __syncthreads();
  const bool src_ok = in_margin(tx, ty, h, w);
  float fx = tx - floorf(tx);
  float fy = ty - floorf(ty);
  float val = lerp4(WV(0, 0), WV(0, 1), WV(1, 0), WV(1, 1), fx, fy);
  float gx = lerp4(WV(0, 1) - WV(0, -1), WV(0, 2) - WV(0, 0),
                   WV(1, 1) - WV(1, -1), WV(1, 2) - WV(1, 0), fx, fy) * 0.5f;
  float gy = lerp4(WV(1, 0) - WV(-1, 0), WV(1, 1) - WV(-1, 1),
                   WV(2, 0) - WV(0, 0), WV(2, 1) - WV(0, 1), fx, fy) * 0.5f;
#undef WV
  // Rotation Jacobian row: grad I . perp(u), perp(u) = (-u_y, u_x).
  const float gt = kRot ? gy * xc - gx * yc : 0.0f;
  float s[NS];
  s[0] = val;
  s[1] = gx;
  s[2] = gy;
  if constexpr (kRot) s[3] = gt;
  block_sum<NS>(s, red, tid);
  const float mean = s[0] / kNpts;
  const float mean_s = fmaxf(mean, kMinMean);
  float tmpl, jx, jy, jt = 0.0f;
  if (ssd) {
    tmpl = val;
    jx = gx;
    jy = gy;
    jt = gt;
  } else {
    tmpl = val / mean_s;
    jx = (gx - tmpl * (s[1] / kNpts)) / mean_s;
    jy = (gy - tmpl * (s[2] / kNpts)) / mean_s;
    if constexpr (kRot) jt = (gt - tmpl * (s[NS - 1] / kNpts)) / mean_s;
  }
  float hs[NH];
  hs[0] = jx * jx;
  hs[1] = jx * jy;
  hs[2] = jy * jy;
  if constexpr (kRot) {
    hs[NH - 3] = jx * jt;
    hs[NH - 2] = jy * jt;
    hs[NH - 1] = jt * jt;
  }
  block_sum<NH>(hs, red, tid);
  const float hxx = hs[0], hxy = hs[1], hyy = hs[2];
  const float energy = hxx + hyy;
  const float hxx_d = hxx + P.lm_lambda;
  const float hyy_d = hyy + P.lm_lambda;
  float det, hjx, hjy, hjt = 0.0f;
  if constexpr (kRot) {
    // Adjugate inverse of the damped symmetric 3x3 system.
    const float hxt = hs[NH - 3], hyt = hs[NH - 2];
    const float htt_d = hs[NH - 1] + P.lm_lambda;
    const float c00 = hyy_d * htt_d - hyt * hyt;
    const float c01 = hxt * hyt - hxy * htt_d;
    const float c02 = hxy * hyt - hxt * hyy_d;
    const float c11 = hxx_d * htt_d - hxt * hxt;
    const float c12 = hxy * hxt - hxx_d * hyt;
    const float c22 = hxx_d * hyy_d - hxy * hxy;
    det = hxx_d * c00 + hxy * c01 + hxt * c02;
    const float det_s = fabsf(det) > kDetEps ? det : 1.0f;
    hjx = (c00 / det_s) * jx + (c01 / det_s) * jy + (c02 / det_s) * jt;
    hjy = (c01 / det_s) * jx + (c11 / det_s) * jy + (c12 / det_s) * jt;
    hjt = (c02 / det_s) * jx + (c12 / det_s) * jy + (c22 / det_s) * jt;
  } else {
    det = hxx_d * hyy_d - hxy * hxy;
    const float det_s = fabsf(det) > kDetEps ? det : 1.0f;
    const float a = hyy_d / det_s;
    const float b = -hxy / det_s;
    const float d = hxx_d / det_s;
    hjx = a * jx + b * jy;
    hjy = b * jx + d * jy;
  }
  const bool patch_ok = src_ok && (ssd || mean > kMinMean) &&
                        energy > (ssd ? kMinGradEnergySsd : kMinGradEnergy) &&
                        fabsf(det) > kDetEps;

  // ---- Gauss-Newton (target image) ----
  bool okf = patch_ok;
  bool active = patch_ok;
  for (int it = 0; it < P.max_iterations && active; ++it) {
    load_window<E, C>(win, dst, h, w, px, py, tid);
    __syncthreads();
    const bool in_img = in_margin(px, py, h, w);
    const float fxs = px - floorf(px);
    const float fys = py - floorf(py);
    float cth = 1.0f, sth = 0.0f, v;
    if constexpr (kRot) {
      cth = cosf(th);
      sth = sinf(th);
      const float dx = (cth - 1.0f) * xc - sth * yc + fxs;
      const float dy = sth * xc + (cth - 1.0f) * yc + fys;
      v = rot_sample<E, B, C>(win, dst, h, w, px, py, dx, dy, r, c);
    } else {
      const int k = (B + r) * E + (B + c);
      v = lerp4(win[k], win[k + 1], win[k + E], win[k + E + 1], fxs, fys);
    }
    float res;
    if (ssd) {
      res = v - tmpl;
    } else {
      float sm[1] = {v};
      block_sum<1>(sm, red, tid);
      res = v / fmaxf(sm[0] / kNpts, kMinMean) - tmpl;
    }
    float inc[ND];
    inc[0] = hjx * res;
    inc[1] = hjy * res;
    if constexpr (kRot) inc[ND - 1] = hjt * res;
    block_sum<ND>(inc, red, tid);
    const float inc_x = -inc[0];
    const float inc_y = -inc[1];
    float ix = inc_x, iy = inc_y, th_new = th;
    float inc_sq = inc_x * inc_x + inc_y * inc_y;
    bool th_ok = true;
    if constexpr (kRot) {
      const float inc_t = -inc[ND - 1];
      th_new = th + inc_t;
      // Compose W <- W o exp(inc): the translation increment is rotated
      // into the current warp frame.
      ix = cth * inc_x - sth * inc_y;
      iy = sth * inc_x + cth * inc_y;
      inc_sq = inc_sq + inc_t * inc_t;
      th_ok = th_new * th_new < kMaxThetaSq;
    }
    const bool step_ok = in_img && isfinite(inc_sq) && inc_sq < 1e12f && th_ok;
    if (step_ok) {
      px = px + ix;
      py = py + iy;
      th = th_new;
    }
    okf = okf && step_ok;
    active = step_ok && inc_sq >= P.conv_thresh_sq;
  }
  return okf && in_margin(px, py, h, w);
}

// Coarse-to-fine over all levels: templates at (tx, ty) (full-res) in
// `src`, Gauss-Newton in `dst`, estimate carried in (cx, cy) (full-res) and
// th (scale-free).
template <bool kRot>
__device__ __forceinline__ bool run_direction(const float* src, const float* dst,
                              const Levels& lv, const Params& P, float tx,
                              float ty, float& cx, float& cy, float& th,
                              float* win, float* red, int tid) {
  bool ok = true;
  for (int lvl = lv.n - 1; lvl >= 0; --lvl) {
    const float s = lv.s[lvl];
    float px = cx * s;
    float py = cy * s;
    float pth = th;
    const bool lok = level_pass<kRot>(
        src + lv.off[lvl], dst + lv.off[lvl], lv.h[lvl], lv.w[lvl], tx * s,
        ty * s, px, py, pth, P, win, red, tid);
    if (lok) {
      cx = px * lv.inv_s[lvl];
      cy = py * lv.inv_s[lvl];
      th = pth;
    }
    if (!P.coarse_tolerant || lvl == 0) ok = ok && lok;
  }
  return ok;
}

// Launch bounds: at least 4 (translation) or 3 (rotation) blocks resident
// per SM. 4 keeps all 512 features of the temporal pass in one wave on 132
// SMs with <= 64 registers; without the bound ptxas chose 48 registers and
// spilled.
template <bool kRot>
__global__ void __launch_bounds__(kThreads, kRot ? 3 : 4)
klt_bidir_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 long long cam_stride, const float* __restrict__ pos,
                 const uint8_t* __restrict__ alive,
                 const int* __restrict__ cam, float* __restrict__ out_pos,
                 float* __restrict__ out_theta, uint8_t* __restrict__ out_ok,
                 Levels lv, Params P) {
  __shared__ float win[kWinMax * kWinMax];
  __shared__ float red[kMaxSums * kWarps];
  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const float sx = pos[2 * f];
  const float sy = pos[2 * f + 1];
  const float* s_img = src + (long long)cam[f] * cam_stride;
  const float* d_img = dst + (long long)cam[f] * cam_stride;

  // forward: prev -> cur, started at the source position and angle 0
  float cx = sx, cy = sy, th_fwd = 0.0f;
  bool ok_fwd = alive[f] != 0;
  if (ok_fwd)
    ok_fwd = run_direction<kRot>(s_img, d_img, lv, P, sx, sy, cx, cy, th_fwd,
                                 win, red, tid);
  const float fx = ok_fwd ? cx : sx;
  const float fy = ok_fwd ? cy : sy;

  // backward: templates at the forward result in cur, Gauss-Newton back in
  // prev, started at the source position and the negated forward angle
  bool ok = false;
  if (ok_fwd) {
    float bx = sx, by = sy, th_b = -th_fwd;
    const bool ok_bwd = run_direction<kRot>(d_img, s_img, lv, P, fx, fy, bx,
                                            by, th_b, win, red, tid);
    const float dx = bx - sx;
    const float dy = by - sy;
    ok = ok_bwd && (dx * dx + dy * dy) < P.bidir_thresh_sq;
  }
  if (tid == 0) {
    out_pos[2 * f] = fx;
    out_pos[2 * f + 1] = fy;
    out_theta[f] = th_fwd;
    out_ok[f] = ok ? 1 : 0;
  }
}

// One level, one direction (TPU: _klt_level_kernel). ok = level ok and
// alive; a dead feature keeps its start position and angle.
template <bool kRot>
__global__ void __launch_bounds__(kThreads, kRot ? 3 : 4)
klt_level_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 long long cam_stride, int h, int w,
                 const float* __restrict__ pos_src,
                 const float* __restrict__ pos_dst0,
                 const float* __restrict__ theta0,
                 const uint8_t* __restrict__ alive,
                 const int* __restrict__ cam, float* __restrict__ out_pos,
                 float* __restrict__ out_theta, uint8_t* __restrict__ out_ok,
                 Params P) {
  __shared__ float win[kWinMax * kWinMax];
  __shared__ float red[kMaxSums * kWarps];
  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  float px = pos_dst0[2 * f];
  float py = pos_dst0[2 * f + 1];
  float th = theta0[f];
  bool ok = false;
  if (alive[f] != 0) {
    ok = level_pass<kRot>(src + (long long)cam[f] * cam_stride,
                          dst + (long long)cam[f] * cam_stride, h, w,
                          pos_src[2 * f], pos_src[2 * f + 1], px, py, th, P,
                          win, red, tid);
  }
  if (tid == 0) {
    out_pos[2 * f] = px;
    out_pos[2 * f + 1] = py;
    out_theta[f] = th;
    out_ok[f] = ok ? 1 : 0;
  }
}

Params make_params(int max_iterations, float conv_thresh_sq,
                   float bidir_thresh_sq, int ssd, float lm_lambda,
                   int coarse_tolerant) {
  Params P;
  P.max_iterations = max_iterations;
  P.conv_thresh_sq = conv_thresh_sq;
  P.bidir_thresh_sq = bidir_thresh_sq;
  P.ssd = ssd;
  P.lm_lambda = lm_lambda;
  P.coarse_tolerant = coarse_tolerant;
  return P;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronize, allocates nothing, and returns a cudaError_t code, -1 for
// bad arguments.

// Fused bidirectional pass. Host arrays h, w, off, s, inv_s hold n_levels
// entries each.
extern "C" int klt_bidir_launch(
    const float* src, const float* dst, long long cam_stride,
    const float* pos, const uint8_t* alive, const int* cam, float* out_pos,
    float* out_theta, uint8_t* out_ok, int n, int n_levels, const int* h,
    const int* w, const long long* off, const float* s, const float* inv_s,
    int max_iterations, float conv_thresh_sq, float bidir_thresh_sq, int ssd,
    float lm_lambda, int coarse_tolerant, int with_rotation, void* stream) {
  if (n < 0 || n_levels < 1 || n_levels > kMaxLevels) return -1;
  Levels lv;
  lv.n = n_levels;
  for (int i = 0; i < n_levels; ++i) {
    if (h[i] < 1 || w[i] < 1) return -1;
    lv.h[i] = h[i];
    lv.w[i] = w[i];
    lv.off[i] = off[i];
    lv.s[i] = s[i];
    lv.inv_s[i] = inv_s[i];
  }
  const Params P = make_params(max_iterations, conv_thresh_sq,
                               bidir_thresh_sq, ssd, lm_lambda,
                               coarse_tolerant);
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (with_rotation) {
      klt_bidir_kernel<true><<<n, kThreads, 0, st>>>(
          src, dst, cam_stride, pos, alive, cam, out_pos, out_theta, out_ok,
          lv, P);
    } else {
      klt_bidir_kernel<false><<<n, kThreads, 0, st>>>(
          src, dst, cam_stride, pos, alive, cam, out_pos, out_theta, out_ok,
          lv, P);
    }
  }
  return (int)cudaGetLastError();
}

// One level of (C, h*w) packed images, positions in level coordinates.
extern "C" int klt_level_launch(
    const float* src, const float* dst, long long cam_stride, int h, int w,
    const float* pos_src, const float* pos_dst0, const float* theta0,
    const uint8_t* alive, const int* cam, float* out_pos, float* out_theta,
    uint8_t* out_ok, int n, int max_iterations, float conv_thresh_sq, int ssd,
    float lm_lambda, int with_rotation, void* stream) {
  if (n < 0 || h < 1 || w < 1) return -1;
  const Params P = make_params(max_iterations, conv_thresh_sq, 0.0f, ssd,
                               lm_lambda, 0);
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (with_rotation) {
      klt_level_kernel<true><<<n, kThreads, 0, st>>>(
          src, dst, cam_stride, h, w, pos_src, pos_dst0, theta0, alive, cam,
          out_pos, out_theta, out_ok, P);
    } else {
      klt_level_kernel<false><<<n, kThreads, 0, st>>>(
          src, dst, cam_stride, h, w, pos_src, pos_dst0, theta0, alive, cam,
          out_pos, out_theta, out_ok, P);
    }
  }
  return (int)cudaGetLastError();
}
