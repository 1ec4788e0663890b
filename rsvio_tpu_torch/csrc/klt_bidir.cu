// Fused bidirectional coarse-to-fine inverse-compositional KLT for Hopper
// (sm_90a). One launch tracks every feature forward over all pyramid levels,
// backward from the forward result, and applies the return-distance gate.
//
// Replaces the TPU kernel track_bidirectional_pyramid / _klt_bidir_kernel in
// rsvio_tpu/ops/pallas/klt_kernel.py, computing the same thing: a dense
// 16x16 unit-spacing patch, bilinear samples and bilinearly interpolated
// central-difference gradients, LSSD mean normalization with the corrected
// Jacobian (or raw SSD), a 2x2 Gauss-Newton system (+ fixed Levenberg
// damping) inverted by adjugate, per-feature freeze on convergence or
// failure, and the strict / coarse-tolerant level policy.
//
// Design. One thread block per feature, one thread per pattern point (256).
// Every Gauss-Newton iteration loads the 20x20 window around the current
// position from the level image in global memory into shared memory, with
// every pixel coordinate clamped to the image: that is the edge replication
// the TPU kernel gets from padding its images. The per-feature sums (mean,
// mean gradient, Hessian, increments) are warp shuffles plus an 8-entry
// shared-memory pass, summed in a fixed order so that every thread of the
// block holds the same value and takes the same branch. A feature leaves its
// Gauss-Newton loop as soon as it converges or fails, which gives the same
// result as the TPU's per-block loop with per-feature freeze. Bilinear
// interpolation is done by hand in fp32 (no texture filtering: its
// fixed-point weights would break parity with the reference).
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
constexpr int kWin = 20;      // 16x16 pattern + bilinear taps + gradient ring
constexpr int kCenter = 9;    // window index of floor(position)
constexpr int kThreads = kPatch * kPatch;
constexpr int kWarps = kThreads / 32;
constexpr float kMargin = 2.0f;
constexpr float kMinMean = 1e-3f;
constexpr float kMinGradEnergy = 1e-4f;
constexpr float kMinGradEnergySsd = 1e-4f * 255.0f * 255.0f;
constexpr float kDetEps = 1e-12f;
constexpr float kNpts = 256.0f;

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

// Loads the kWin x kWin window whose index (kCenter, kCenter) is
// floor(p), clamping each pixel coordinate into the image.
__device__ void load_window(float* win, const float* img, int h, int w,
                            float px, float py, int tid) {
  // Non-finite or far-away positions get some in-image window; such a
  // feature fails its margin test, so the values are never used.
  float fx = fminf(fmaxf(floorf(px), -1e6f), 1e6f);
  float fy = fminf(fmaxf(floorf(py), -1e6f), 1e6f);
  int bx = (int)fx - kCenter;
  int by = (int)fy - kCenter;
  for (int k = tid; k < kWin * kWin; k += kThreads) {
    int j = k / kWin;
    int i = k - j * kWin;
    int y = min(max(by + j, 0), h - 1);
    int x = min(max(bx + i, 0), w - 1);
    win[k] = img[(long long)y * w + x];
  }
}

// Block-wide sums of K values. Every thread returns the same totals.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red,
                                          int tid) {
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

// One pyramid level of IC-KLT for the block's feature: template at (tx, ty)
// in `src`, Gauss-Newton from (px, py) in `dst` (level coordinates).
// Returns the level's ok flag; (px, py) holds the final position.
__device__ bool level_pass(const float* src, const float* dst, int h, int w,
                           float tx, float ty, float& px, float& py,
                           const Params& P, float* win, float* red, int tid) {
  const int r = tid / kPatch;
  const int c = tid - r * kPatch;
  const bool ssd = P.ssd != 0;
#define WV(dy, dx) win[(1 + r + (dy)) * kWin + (1 + c + (dx))]

  // ---- template (source image) ----
  __syncthreads();
  load_window(win, src, h, w, tx, ty, tid);
  __syncthreads();
  const bool src_ok = in_margin(tx, ty, h, w);
  float fx = tx - floorf(tx);
  float fy = ty - floorf(ty);
  float val = lerp4(WV(0, 0), WV(0, 1), WV(1, 0), WV(1, 1), fx, fy);
  float gx = lerp4(WV(0, 1) - WV(0, -1), WV(0, 2) - WV(0, 0),
                   WV(1, 1) - WV(1, -1), WV(1, 2) - WV(1, 0), fx, fy) * 0.5f;
  float gy = lerp4(WV(1, 0) - WV(-1, 0), WV(1, 1) - WV(-1, 1),
                   WV(2, 0) - WV(0, 0), WV(2, 1) - WV(0, 1), fx, fy) * 0.5f;
  float s3[3] = {val, gx, gy};
  block_sum<3>(s3, red, tid);
  const float mean = s3[0] / kNpts;
  const float mean_s = fmaxf(mean, kMinMean);
  float tmpl, jx, jy;
  if (ssd) {
    tmpl = val;
    jx = gx;
    jy = gy;
  } else {
    tmpl = val / mean_s;
    const float mgx = s3[1] / kNpts;
    const float mgy = s3[2] / kNpts;
    jx = (gx - tmpl * mgx) / mean_s;
    jy = (gy - tmpl * mgy) / mean_s;
  }
  float hs[3] = {jx * jx, jx * jy, jy * jy};
  block_sum<3>(hs, red, tid);
  const float hxx = hs[0], hxy = hs[1], hyy = hs[2];
  const float energy = hxx + hyy;
  const float hxx_d = hxx + P.lm_lambda;
  const float hyy_d = hyy + P.lm_lambda;
  const float det = hxx_d * hyy_d - hxy * hxy;
  const float det_s = fabsf(det) > kDetEps ? det : 1.0f;
  const float a = hyy_d / det_s;
  const float b = -hxy / det_s;
  const float d = hxx_d / det_s;
  const float hjx = a * jx + b * jy;
  const float hjy = b * jx + d * jy;
  const bool patch_ok = src_ok && (ssd || mean > kMinMean) &&
                        energy > (ssd ? kMinGradEnergySsd : kMinGradEnergy) &&
                        fabsf(det) > kDetEps;

  // ---- Gauss-Newton (target image) ----
  bool okf = patch_ok;
  bool active = patch_ok;
  for (int it = 0; it < P.max_iterations && active; ++it) {
    load_window(win, dst, h, w, px, py, tid);
    __syncthreads();
    const bool in_img = in_margin(px, py, h, w);
    float fxs = px - floorf(px);
    float fys = py - floorf(py);
    float v = lerp4(WV(0, 0), WV(0, 1), WV(1, 0), WV(1, 1), fxs, fys);
    float res;
    if (ssd) {
      res = v - tmpl;
    } else {
      float sm[1] = {v};
      block_sum<1>(sm, red, tid);
      res = v / fmaxf(sm[0] / kNpts, kMinMean) - tmpl;
    }
    float inc[2] = {hjx * res, hjy * res};
    block_sum<2>(inc, red, tid);
    const float ix = -inc[0];
    const float iy = -inc[1];
    const float inc_sq = ix * ix + iy * iy;
    const bool step_ok = in_img && isfinite(inc_sq) && inc_sq < 1e12f;
    if (step_ok) {
      px = px + ix;
      py = py + iy;
    }
    okf = okf && step_ok;
    active = step_ok && inc_sq >= P.conv_thresh_sq;
  }
#undef WV
  return okf && in_margin(px, py, h, w);
}

// Coarse-to-fine over all levels: templates at (tx, ty) (full-res) in
// `src`, Gauss-Newton in `dst`, estimate carried in (cx, cy) (full-res).
__device__ bool run_direction(const float* src, const float* dst,
                              const Levels& lv, const Params& P, float tx,
                              float ty, float& cx, float& cy, float* win,
                              float* red, int tid) {
  bool ok = true;
  for (int lvl = lv.n - 1; lvl >= 0; --lvl) {
    const float s = lv.s[lvl];
    float px = cx * s;
    float py = cy * s;
    const bool lok = level_pass(src + lv.off[lvl], dst + lv.off[lvl],
                                lv.h[lvl], lv.w[lvl], tx * s, ty * s, px, py,
                                P, win, red, tid);
    if (lok) {
      cx = px * lv.inv_s[lvl];
      cy = py * lv.inv_s[lvl];
    }
    if (!P.coarse_tolerant || lvl == 0) ok = ok && lok;
  }
  return ok;
}

__global__ void __launch_bounds__(kThreads)
klt_bidir_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 long long cam_stride, const float* __restrict__ pos,
                 const uint8_t* __restrict__ alive,
                 const int* __restrict__ cam, float* __restrict__ out_pos,
                 float* __restrict__ out_theta, uint8_t* __restrict__ out_ok,
                 Levels lv, Params P) {
  __shared__ float win[kWin * kWin];
  __shared__ float red[3 * kWarps];
  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const float sx = pos[2 * f];
  const float sy = pos[2 * f + 1];
  const float* s_img = src + (long long)cam[f] * cam_stride;
  const float* d_img = dst + (long long)cam[f] * cam_stride;

  // forward: prev -> cur, started at the source position
  float cx = sx, cy = sy;
  bool ok_fwd = alive[f] != 0;
  if (ok_fwd)
    ok_fwd = run_direction(s_img, d_img, lv, P, sx, sy, cx, cy, win, red, tid);
  const float fx = ok_fwd ? cx : sx;
  const float fy = ok_fwd ? cy : sy;

  // backward: templates at the forward result in cur, Gauss-Newton back in
  // prev, started at the source position (as the reference does)
  bool ok = false;
  if (ok_fwd) {
    float bx = sx, by = sy;
    const bool ok_bwd =
        run_direction(d_img, s_img, lv, P, fx, fy, bx, by, win, red, tid);
    const float dx = bx - sx;
    const float dy = by - sy;
    ok = ok_bwd && (dx * dx + dy * dy) < P.bidir_thresh_sq;
  }
  if (tid == 0) {
    out_pos[2 * f] = fx;
    out_pos[2 * f + 1] = fy;
    out_theta[f] = 0.0f;
    out_ok[f] = ok ? 1 : 0;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Host arrays h, w, off, s, inv_s
// hold n_levels entries each. Launches on `stream`, does not synchronize,
// allocates nothing. Returns a cudaError_t code, -1 for bad arguments.
extern "C" int klt_bidir_launch(
    const float* src, const float* dst, long long cam_stride,
    const float* pos, const uint8_t* alive, const int* cam, float* out_pos,
    float* out_theta, uint8_t* out_ok, int n, int n_levels, const int* h,
    const int* w, const long long* off, const float* s, const float* inv_s,
    int max_iterations, float conv_thresh_sq, float bidir_thresh_sq, int ssd,
    float lm_lambda, int coarse_tolerant, void* stream) {
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
  Params P;
  P.max_iterations = max_iterations;
  P.conv_thresh_sq = conv_thresh_sq;
  P.bidir_thresh_sq = bidir_thresh_sq;
  P.ssd = ssd;
  P.lm_lambda = lm_lambda;
  P.coarse_tolerant = coarse_tolerant;
  if (n > 0) {
    klt_bidir_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
        src, dst, cam_stride, pos, alive, cam, out_pos, out_theta, out_ok, lv,
        P);
  }
  return (int)cudaGetLastError();
}
