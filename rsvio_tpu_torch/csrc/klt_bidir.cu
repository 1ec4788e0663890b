// Inverse-compositional KLT for Hopper (sm_90a): the fused bidirectional
// coarse-to-fine pass (klt_bidir_launch; K1, and K1-rot with rotation) and
// the one-level pass (klt_level_launch; K2), each in a translation (2-dof)
// and an SE2 rotation (3-dof) variant.
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
// coarse-tolerant level policy. Every pixel coordinate is clamped into the
// image: that is the edge replication the TPU kernel gets from padding its
// images. The rotation variant samples each pattern point bilinearly at its
// own rotated coordinate center + u + (R(theta)-I)u + frac, u = (c-8, r-8),
// with the hat weights of the TPU kernel's _rot_sample; the template and its
// gradients stay unrotated. Bilinear interpolation is done by hand in fp32
// (texture filtering's fixed-point weights would break parity with the
// plain version).
//
// What bounds both on the H100: neither bytes nor operations (a call reads
// a few MB, mostly from L2, and its arithmetic is ~50x below its time) but
// the dependent chain of each feature: 1 template + up to max_iterations
// Gauss-Newton steps per level stage, over 2 directions x levels stages in
// the fused pass and one stage in the one-level pass. A call lasts as long
// as its longest chain, so what the design shortens is each link.
//
// Design: one warp per feature, kWarpsPerBlock features per block, and one
// level stage (level_stage: copy the template window and the target tile,
// build the template, run Gauss-Newton) that both kernels call. What made a
// link long in the earlier one-block-per-feature design, and what this one
// does about it:
//   1. The window went back to global memory at every Gauss-Newton step
//      (one dependent L2 round trip per link). Now per stage (one level of
//      one direction) the warp stages a 32x32 tile of the target level in
//      its shared memory, and each step reads its taps from the tile. A
//      step whose support (17x17; for rotation the box of the rotated taps
//      at the current angle, at most 27x27 inside the theta gate) leaves
//      the tile re-stages it around the current position, so results are
//      exact for any travel. A rotated tap outside the tile (only for an
//      angle whose box is wider than the tile, or a non-finite angle, which
//      the one-level pass may be given) is read from the image.
//   2. Block-wide sums cost two __syncthreads and a pass through shared
//      memory each. Now lane l owns 8 pattern points (row l/2, columns
//      8(l&1)..+7) and keeps their template values and H^-1 J rows in
//      registers; a per-feature sum is a tree of 8 adds in the lane and a
//      5-step __shfl_xor_sync butterfly. Float addition is commutative, so
//      the two lanes of every butterfly pair compute the same bits, all 32
//      lanes end with the same sums, position and angle, and take the same
//      branches. The level body has no block barrier, only __syncwarp
//      around shared-memory writes, and each warp leaves its loops on its
//      own.
//   3. An LSSD step takes the mean of its samples before its increment sums:
//      two butterflies in a row, the order of the plain version's arithmetic.
//      Folding them into one (inc = sum(hj v) / mean - sum(hj tmpl)) made
//      translation 3-8 % faster at N <= 2048 but moved a position by
//      1.2e-3 px at N=8192, past the 1e-3 px parity bound, so it was dropped.
//   4. The template window and the first target window loaded one after the
//      other. Now per stage the warp issues the template window (19x19 of
//      the template image) and the tile together, as 4-byte cp.async copies
//      from clamped addresses, and waits once. Copying the next level's
//      window and tile into a second set of buffers during Gauss-Newton was
//      4-18 % slower: issuing the copies lengthened the chain more than the
//      wait it saved.
// Sums by a per-feature value use its reciprocal: one IEEE division per
// template (mean, determinant) and per LSSD step (mean), not one per point
// (a division is a branch to a slow path in SASS, which serializes a lane's
// points). TMA is not used: its out-of-bounds fill is zero, not the edge
// pixel, and a tile is 4 KB at a per-feature origin. Every tile value is the
// clamped image pixel the window of the plain version holds, so kernel and
// plain version sample the same values; they differ in the order of their
// sums and, by an ulp, where the kernel multiplies by a reciprocal.
// (Timings: chip_smoke.py on an H100; the numbers are in PERF.md.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr float kMargin = 2.0f;
constexpr float kMinMean = 1e-3f;
constexpr float kMinGradEnergy = 1e-4f;
constexpr float kMinGradEnergySsd = 1e-4f * 255.0f * 255.0f;
constexpr float kDetEps = 1e-12f;
constexpr float kNpts = 256.0f;
constexpr float kMaxThetaSq = 0.12f;   // theta step gate (TPU: _MAX_THETA_SQ)

// Warp per feature. Features per block: of 2, 4 and 8, 2 is the fastest on
// the main path's two passes, and 1 is within 1 % (PERF.md). 16 resident
// warps per SM bound the registers at 128, without spills.
constexpr int kWarpsPerBlock = 2;
constexpr int kWarpsPerSm = 16;
constexpr int kWarpThreads = 32 * kWarpsPerBlock;
constexpr int kPts = 8;                // pattern points per lane
constexpr int kTile = 32;              // target tile edge (px)
constexpr int kTileC = 15;             // tile index of floor(position) when staged
constexpr int kTileS = 33;             // tile row stride (floats)
constexpr int kTmplE = 19;             // template window edge: 16 + 3 gradient taps
constexpr int kTmplS = 21;             // template window row stride (floats)
constexpr int kTileFloats = kTile * kTileS;
constexpr int kTmplFloats = kTmplE * kTmplS;
constexpr int kWarpFloats = kTileFloats + kTmplFloats;
static_assert(kWarpsPerBlock * kWarpFloats * 4 <= 48 * 1024,
              "static shared memory of a block");

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

// floor(p) as an int, clamped to +-1e6. Non-finite or far-away positions
// get some in-image window or tile; such a feature fails its margin test,
// so the values are never used.
__device__ __forceinline__ int clamp_floor(float p) {
  return (int)fminf(fmaxf(floorf(p), -1e6f), 1e6f);
}

__device__ __forceinline__ float clamped_pixel(const float* img, int h, int w,
                                               int y, int x) {
  y = min(max(y, 0), h - 1);
  x = min(max(x, 0), w - 1);
  return img[(long long)y * w + x];
}

// Hat (bilinear) weight max(0, 1 - |d - k|); NaN stays NaN, as jnp.maximum.
__device__ __forceinline__ float hat(float d, float k) {
  const float t = 1.0f - fabsf(d - k);
  return t < 0.0f ? 0.0f : t;
}

// ---------------------------------------------------------------------------
// The level stage of one feature, run by one warp
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst_smem,
                                          const float* src_gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst_smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src_gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of rows [y0, y0 + ROWS) x columns [x0, x0 + COLS) of
// `img` into `buf` (row stride S), every pixel coordinate clamped into the
// image. Lane i copies column i, one 4-byte cp.async per row, so each row is
// one coalesced read. The caller waits (cp_async_wait_all + __syncwarp).
template <int ROWS, int COLS, int S>
__device__ __forceinline__ void stage(float* buf, const float* img, int h,
                                      int w, int x0, int y0, int lane) {
  if (lane < COLS) {
    const float* col = img + min(max(x0 + lane, 0), w - 1);
#pragma unroll 8
    for (int j = 0; j < ROWS; ++j) {
      const int y = min(max(y0 + j, 0), h - 1);
      cp_async4(buf + j * S + lane, col + (long long)y * w);
    }
  }
}

__device__ __forceinline__ void stage_tile(float* tile, const float* img,
                                           int h, int w, int ox, int oy,
                                           int lane) {
  stage<kTile, kTile, kTileS>(tile, img, h, w, ox, oy, lane);
}

// The template window: image pixel floor(t) - 9 + (j, i) at (j, i).
__device__ __forceinline__ void stage_window(float* win, const float* img,
                                             int h, int w, float tx, float ty,
                                             int lane) {
  stage<kTmplE, kTmplE, kTmplS>(win, img, h, w, clamp_floor(tx) - 9,
                                clamp_floor(ty) - 9, lane);
}

// Per-feature sums of K values: every lane returns the same totals.
template <int K>
__device__ __forceinline__ void warp_sums(float* v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
}

__device__ __forceinline__ float sum8(const float* x) {
  return ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
}

// Half-width of the pixel box around floor(p) that a Gauss-Newton step at
// angle (cth, sth) reads: 8 for translation; the rotated taps reach
// 8 (|cos - 1| + |sin|) + 1 further (plus 1 for rounding). A non-finite
// angle (NaN cos and sin) gets 74, wider than any tile, so its taps are read
// with bounds checks (fminf returns the operand that is not NaN).
template <bool kRot>
__device__ __forceinline__ int support(float cth, float sth) {
  if constexpr (kRot)
    return 10 + (int)fminf(8.0f * (fabsf(cth - 1.0f) + fabsf(sth)), 64.0f);
  return 8;
}

__device__ __forceinline__ bool covers(int ox, int oy, int fx0, int fy0,
                                       int rad) {
  return fx0 - rad >= ox && fx0 + rad < ox + kTile && fy0 - rad >= oy &&
         fy0 + rad < oy + kTile;
}

// Bilinear sample of a pattern point whose unrotated tap is image pixel
// (x, y), displaced by (dx, dy): taps at floor(d) and floor(d) + 1 with hat
// weights (the TPU kernel's _rot_sample). With kChecked, taps outside the
// tile (origin ox, oy) come from the image (clamped; the same values);
// without, the caller guarantees all four lie in the tile.
template <bool kChecked>
__device__ __forceinline__ float rot_tap(const float* tile, int ox, int oy,
                                         const float* img, int h, int w, int x,
                                         int y, float dx, float dy) {
  const float kx = fminf(fmaxf(floorf(dx), -64.0f), 64.0f);
  const float ky = fminf(fmaxf(floorf(dy), -64.0f), 64.0f);
  const float wx0 = hat(dx, kx), wx1 = hat(dx, kx + 1.0f);
  const float wy0 = hat(dy, ky), wy1 = hat(dy, ky + 1.0f);
  const int X = x + (int)kx;
  const int Y = y + (int)ky;
  const int rx = X - ox;
  const int ry = Y - oy;
  float v00, v01, v10, v11;
  if (!kChecked || (rx >= 0 && rx < kTile - 1 && ry >= 0 && ry < kTile - 1)) {
    const float* q = tile + ry * kTileS + rx;
    v00 = q[0];
    v01 = q[1];
    v10 = q[kTileS];
    v11 = q[kTileS + 1];
  } else {
    v00 = clamped_pixel(img, h, w, Y, X);
    v01 = clamped_pixel(img, h, w, Y, X + 1);
    v10 = clamped_pixel(img, h, w, Y + 1, X);
    v11 = clamped_pixel(img, h, w, Y + 1, X + 1);
  }
  const float row0 = wx0 * v00 + wx1 * v01;
  const float row1 = wx0 * v10 + wx1 * v11;
  return wy0 * row0 + wy1 * row1;
}

// One feature's template at one level, in the lane's registers: its 8
// points' template values and rows of H^-1 J.
template <bool kRot>
struct Template {
  static constexpr int ND = kRot ? 3 : 2;   // degrees of freedom
  float tmpl[kPts];
  float hj[ND][kPts];
  bool ok;               // the patch can be tracked
};

// Builds the template at (tx, ty) (level coordinates) from the staged
// window `win` (stage_window). Pattern point (r, c) with offset (dy, dx)
// sits at window index (r + 1 + dy, c + 1 + dx).
template <bool kRot>
__device__ __forceinline__ void build_template(const float* win, int h, int w,
                                               float tx, float ty,
                                               const Params& P, int lane,
                                               Template<kRot>& T) {
  constexpr int NS = kRot ? 4 : 3;    // template sums
  constexpr int NH = kRot ? 6 : 3;    // Hessian entries
  constexpr int ND = Template<kRot>::ND;
  const int r = lane >> 1;            // pattern row of the lane's points
  const int c0 = (lane & 1) * kPts;   // pattern column of its first point
  const float yc = (float)(r - 8);    // pattern offset from the tracked point
  const bool ssd = P.ssd != 0;
  const float fx = tx - floorf(tx);
  const float fy = ty - floorf(ty);
  // tmpl / jx / jy / jt start as the samples and gradients (the SSD
  // template and Jacobian) and are normalized in place for LSSD.
  float* tmpl = T.tmpl;
  float jx[kPts], jy[kPts], jt[kPts];
  {
    float a[4][kPts + 3];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < kPts + 3; ++j) a[i][j] = win[(r + i) * kTmplS + c0 + j];
    }
#define WV(dy, dx) a[1 + (dy)][1 + k + (dx)]
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      tmpl[k] = lerp4(WV(0, 0), WV(0, 1), WV(1, 0), WV(1, 1), fx, fy);
      jx[k] = lerp4(WV(0, 1) - WV(0, -1), WV(0, 2) - WV(0, 0),
                    WV(1, 1) - WV(1, -1), WV(1, 2) - WV(1, 0), fx, fy) * 0.5f;
      jy[k] = lerp4(WV(1, 0) - WV(-1, 0), WV(1, 1) - WV(-1, 1),
                    WV(2, 0) - WV(0, 0), WV(2, 1) - WV(0, 1), fx, fy) * 0.5f;
      // Rotation Jacobian row: grad I . perp(u), perp(u) = (-u_y, u_x).
      jt[k] = kRot ? jy[k] * (float)(c0 + k - 8) - jx[k] * yc : 0.0f;
    }
#undef WV
  }
  float s[NS];
  s[0] = sum8(tmpl);
  s[1] = sum8(jx);
  s[2] = sum8(jy);
  if constexpr (kRot) s[3] = sum8(jt);
  warp_sums<NS>(s);
  const float mean = s[0] / kNpts;
  if (!ssd) {
    const float rmean = 1.0f / fmaxf(mean, kMinMean);
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const float t = tmpl[k] * rmean;
      tmpl[k] = t;
      jx[k] = (jx[k] - t * (s[1] / kNpts)) * rmean;
      jy[k] = (jy[k] - t * (s[2] / kNpts)) * rmean;
      if constexpr (kRot) jt[k] = (jt[k] - t * (s[NS - 1] / kNpts)) * rmean;
    }
  }
  float hs[NH];
  {
    float t[NH][kPts];
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      t[0][k] = jx[k] * jx[k];
      t[1][k] = jx[k] * jy[k];
      t[2][k] = jy[k] * jy[k];
      if constexpr (kRot) {
        t[NH - 3][k] = jx[k] * jt[k];
        t[NH - 2][k] = jy[k] * jt[k];
        t[NH - 1][k] = jt[k] * jt[k];
      }
    }
#pragma unroll
    for (int i = 0; i < NH; ++i) hs[i] = sum8(t[i]);
  }
  warp_sums<NH>(hs);
  const float hxx = hs[0], hxy = hs[1], hyy = hs[2];
  const float energy = hxx + hyy;
  const float hxx_d = hxx + P.lm_lambda;
  const float hyy_d = hyy + P.lm_lambda;
  float det;
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
    const float rdet = 1.0f / (fabsf(det) > kDetEps ? det : 1.0f);
    const float i00 = c00 * rdet, i01 = c01 * rdet, i02 = c02 * rdet;
    const float i11 = c11 * rdet, i12 = c12 * rdet, i22 = c22 * rdet;
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      T.hj[0][k] = i00 * jx[k] + i01 * jy[k] + i02 * jt[k];
      T.hj[1][k] = i01 * jx[k] + i11 * jy[k] + i12 * jt[k];
      T.hj[ND - 1][k] = i02 * jx[k] + i12 * jy[k] + i22 * jt[k];
    }
  } else {
    det = hxx_d * hyy_d - hxy * hxy;
    const float rdet = 1.0f / (fabsf(det) > kDetEps ? det : 1.0f);
    const float a = hyy_d * rdet;
    const float b = -hxy * rdet;
    const float d = hxx_d * rdet;
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      T.hj[0][k] = a * jx[k] + b * jy[k];
      T.hj[1][k] = b * jx[k] + d * jy[k];
    }
  }
  T.ok = in_margin(tx, ty, h, w) && (ssd || mean > kMinMean) &&
         energy > (ssd ? kMinGradEnergySsd : kMinGradEnergy) &&
         fabsf(det) > kDetEps;
}

// Gauss-Newton from (px, py) and angle th (level coordinates) in `img`,
// taps from `tile` (origin ox, oy; re-staged when the support leaves it).
// Returns the level's ok flag; (px, py, th) hold the final warp (th is
// only changed by the rotation variant).
template <bool kRot>
__device__ __forceinline__ bool gauss_newton(const Template<kRot>& T,
                                             float* tile, int& ox, int& oy,
                                             const float* img, int h, int w,
                                             float& px, float& py, float& th,
                                             const Params& P, int lane) {
  constexpr int ND = Template<kRot>::ND;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * kPts;
  const float yc = (float)(r - 8);
  const bool ssd = P.ssd != 0;
  bool okf = T.ok;
  bool active = T.ok;
  for (int it = 0; it < P.max_iterations && active; ++it) {
    const int fx0 = clamp_floor(px);
    const int fy0 = clamp_floor(py);
    float cth = 1.0f, sth = 0.0f;
    if constexpr (kRot) {
      cth = cosf(th);
      sth = sinf(th);
    }
    const int rad = support<kRot>(cth, sth);
    if (!covers(ox, oy, fx0, fy0, rad)) {
      // The support left the tile: re-stage it around the iterate.
      ox = fx0 - kTileC;
      oy = fy0 - kTileC;
      __syncwarp();
      stage_tile(tile, img, h, w, ox, oy, lane);
      cp_async_wait_all();
      __syncwarp();
    }
    const bool in_img = in_margin(px, py, h, w);
    const float fxs = px - floorf(px);
    const float fys = py - floorf(py);
    float v[kPts];
    if constexpr (kRot) {
      const bool fits = rad <= kTileC;   // then every tap lies in the tile
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        const float xc = (float)(c0 + k - 8);
        const float dx = (cth - 1.0f) * xc - sth * yc + fxs;
        const float dy = sth * xc + (cth - 1.0f) * yc + fys;
        const int x = fx0 - 8 + c0 + k;
        const int y = fy0 - 8 + r;
        v[k] = fits ? rot_tap<false>(tile, ox, oy, img, h, w, x, y, dx, dy)
                    : rot_tap<true>(tile, ox, oy, img, h, w, x, y, dx, dy);
      }
    } else {
      const float* q = tile + (fy0 - 8 + r - oy) * kTileS + (fx0 - 8 + c0 - ox);
      float a[kPts + 1], b[kPts + 1];
#pragma unroll
      for (int j = 0; j <= kPts; ++j) {
        a[j] = q[j];
        b[j] = q[kTileS + j];
      }
#pragma unroll
      for (int k = 0; k < kPts; ++k)
        v[k] = lerp4(a[k], a[k + 1], b[k], b[k + 1], fxs, fys);
    }
    float res[kPts];
    if (ssd) {
#pragma unroll
      for (int k = 0; k < kPts; ++k) res[k] = v[k] - T.tmpl[k];
    } else {
      // LSSD: the mean of the samples first, then the increment sums.
      float sm[1] = {sum8(v)};
      warp_sums<1>(sm);
      const float rm = 1.0f / fmaxf(sm[0] / kNpts, kMinMean);
#pragma unroll
      for (int k = 0; k < kPts; ++k) res[k] = v[k] * rm - T.tmpl[k];
    }
    float inc[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float p[kPts];
#pragma unroll
      for (int k = 0; k < kPts; ++k) p[k] = T.hj[d][k] * res[k];
      inc[d] = sum8(p);
    }
    warp_sums<ND>(inc);
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

// One level stage of one feature, run by its warp: the template at (tx, ty)
// in `a_img`, then Gauss-Newton from (px, py) and angle th in `b_img` (one
// h x w level image each, level coordinates). The template window and the
// tile around the start are copied together, with one wait. Returns the
// level's ok; (px, py, th) hold the final iterate, even when the level
// fails.
template <bool kRot>
__device__ __forceinline__ bool level_stage(float* win, float* tile,
                                            const float* a_img,
                                            const float* b_img, int h, int w,
                                            float tx, float ty, float& px,
                                            float& py, float& th,
                                            const Params& P, int lane) {
  int ox = clamp_floor(px) - kTileC;
  int oy = clamp_floor(py) - kTileC;
  __syncwarp();   // every lane is done with the previous stage's buffers
  stage_window(win, a_img, h, w, tx, ty, lane);
  stage_tile(tile, b_img, h, w, ox, oy, lane);
  cp_async_wait_all();
  __syncwarp();
  Template<kRot> T;
  build_template<kRot>(win, h, w, tx, ty, P, lane, T);
  return gauss_newton<kRot>(T, tile, ox, oy, b_img, h, w, px, py, th, P,
                            lane);
}

// ---------------------------------------------------------------------------
// The kernels: one warp per feature, kWarpsPerBlock features per block.
// Launch bounds: kWarpsPerSm warps resident per SM, so at most
// 65536 / (32 kWarpsPerSm) registers a thread. A warp whose feature index
// is past n returns whole; no block barrier follows.
// ---------------------------------------------------------------------------

// The fused pass: forward over the levels from the coarsest (templates at
// the source position in `src`, Gauss-Newton in `dst`, started at the
// source position and angle 0), then, if the forward track is ok, backward
// (templates at the forward result in `dst`, Gauss-Newton in `src`, started
// at the source position and the negated forward angle), and the return
// gate. The 2 x levels stages run in one loop, so the stage is compiled
// once (two inlined copies, one per direction, made the rotation variant
// ~30 % slower). A failed level keeps the previous estimate.
template <bool kRot>
__global__ void __launch_bounds__(kWarpThreads, kWarpsPerSm / kWarpsPerBlock)
klt_bidir_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 long long cam_stride, const float* __restrict__ pos,
                 const uint8_t* __restrict__ alive,
                 const int* __restrict__ cam, float* __restrict__ out_pos,
                 float* __restrict__ out_theta, uint8_t* __restrict__ out_ok,
                 int n, Levels lv, Params P) {
  __shared__ float smem[kWarpsPerBlock * kWarpFloats];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int f = blockIdx.x * kWarpsPerBlock + wib;
  if (f >= n) return;
  float* win = smem + wib * kWarpFloats;
  float* tile = win + kTmplFloats;
  const float sx = pos[2 * f];
  const float sy = pos[2 * f + 1];
  const float* s_img = src + (long long)cam[f] * cam_stride;
  const float* d_img = dst + (long long)cam[f] * cam_stride;
  const int L = lv.n;

  // The running direction: templates in a_img at (tx, ty), Gauss-Newton in
  // b_img from the estimate (cx, cy) (full-res) and th.
  const float* a_img = s_img;
  const float* b_img = d_img;
  float tx = sx, ty = sy, cx = sx, cy = sy, th = 0.0f;
  const bool live = alive[f] != 0;
  bool ok = live;
  bool ok_fwd = false;
  float th_fwd = 0.0f;
  for (int k = 0; live && k < 2 * L; ++k) {
    const int lvl = k < L ? L - 1 - k : 2 * L - 1 - k;
    const float s = lv.s[lvl];
    float px = cx * s, py = cy * s, pth = th;
    const bool lok = level_stage<kRot>(
        win, tile, a_img + lv.off[lvl], b_img + lv.off[lvl], lv.h[lvl],
        lv.w[lvl], tx * s, ty * s, px, py, pth, P, lane);
    if (lok) {
      cx = px * lv.inv_s[lvl];
      cy = py * lv.inv_s[lvl];
      th = pth;
    }
    if (!P.coarse_tolerant || lvl == 0) ok = ok && lok;
    if (k == L - 1) {   // the forward direction is done
      ok_fwd = ok;
      th_fwd = th;
      if (!ok_fwd) break;
      a_img = d_img;
      b_img = s_img;
      tx = cx;
      ty = cy;
      cx = sx;
      cy = sy;
      th = -th_fwd;
    }
  }
  const float dx = cx - sx;
  const float dy = cy - sy;
  if (lane == 0) {
    out_pos[2 * f] = ok_fwd ? tx : sx;
    out_pos[2 * f + 1] = ok_fwd ? ty : sy;
    out_theta[f] = th_fwd;
    out_ok[f] = ok_fwd && ok && (dx * dx + dy * dy) < P.bidir_thresh_sq;
  }
}

// One level, one direction (TPU: _klt_level_kernel): one stage, template at
// pos_src in `src`, Gauss-Newton from (pos_dst0, theta0) in `dst`. Returns
// the final iterate even when the level fails; ok = level ok and alive. A
// dead feature returns pos_dst0 and theta0 unchanged, and the translation
// variant always returns theta0.
template <bool kRot>
__global__ void __launch_bounds__(kWarpThreads, kWarpsPerSm / kWarpsPerBlock)
klt_level_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 long long cam_stride, int h, int w,
                 const float* __restrict__ pos_src,
                 const float* __restrict__ pos_dst0,
                 const float* __restrict__ theta0,
                 const uint8_t* __restrict__ alive,
                 const int* __restrict__ cam, float* __restrict__ out_pos,
                 float* __restrict__ out_theta, uint8_t* __restrict__ out_ok,
                 int n, Params P) {
  __shared__ float smem[kWarpsPerBlock * kWarpFloats];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int f = blockIdx.x * kWarpsPerBlock + wib;
  if (f >= n) return;
  float* win = smem + wib * kWarpFloats;
  float* tile = win + kTmplFloats;
  float px = pos_dst0[2 * f];
  float py = pos_dst0[2 * f + 1];
  float th = theta0[f];
  bool ok = false;
  if (alive[f] != 0) {
    const long long c = (long long)cam[f] * cam_stride;
    ok = level_stage<kRot>(win, tile, src + c, dst + c, h, w, pos_src[2 * f],
                           pos_src[2 * f + 1], px, py, th, P, lane);
  }
  if (lane == 0) {
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
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (with_rotation) {
      klt_bidir_kernel<true><<<blocks, kWarpThreads, 0, st>>>(
          src, dst, cam_stride, pos, alive, cam, out_pos, out_theta, out_ok,
          n, lv, P);
    } else {
      klt_bidir_kernel<false><<<blocks, kWarpThreads, 0, st>>>(
          src, dst, cam_stride, pos, alive, cam, out_pos, out_theta, out_ok,
          n, lv, P);
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
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (with_rotation) {
      klt_level_kernel<true><<<blocks, kWarpThreads, 0, st>>>(
          src, dst, cam_stride, h, w, pos_src, pos_dst0, theta0, alive, cam,
          out_pos, out_theta, out_ok, n, P);
    } else {
      klt_level_kernel<false><<<blocks, kWarpThreads, 0, st>>>(
          src, dst, cam_stride, h, w, pos_src, pos_dst0, theta0, alive, cam,
          out_pos, out_theta, out_ok, n, P);
    }
  }
  return (int)cudaGetLastError();
}
