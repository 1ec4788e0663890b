// The window solve's visual assembly for Hopper (sm_90a): linearization,
// Huber and observation weights, and the normal-equation blocks of one
// Levenberg-Marquardt system, for the observation mask and, in the same
// pass, for its chi^2-gated subset (ba_assemble_launch; K3).
//
// It replaces no TPU kernel: the JAX package leaves this work to XLA's
// fusions inside its jitted solves. The port ran it as ~100 PyTorch
// kernels per system (linearize_projection, apply_obs_weights,
// build_normal_equations), twice an LM iteration with the chi^2 gate on,
// and on the card each of those kernels costs the launch-and-drain time of
// a tiny kernel (~1.5 us), far above its work. This kernel computes what
// ops/cuda/ba_kernel.ba_assemble_reference computes:
//   - per observation (w, c, l): p_C = T_C_B[c] T_B_W[w] p_W[l], the
//     cheirality residual (CHEIRALITY_RESIDUAL behind the camera), the
//     analytic Jacobians, the Huber weight and cost, the sqrt-weight
//     scaling, and r_sq = |r|^2 of the whitened residual;
//   - H_pp (W,6,6), g_p (W,6), H_ll (L,3,3), H_pl (W,L,6,3), g_l (L,3) and
//     the cost sum over the mask;
//   - with a gate > 0 the same blocks for m = mask & (r_sq <= gate^2) &
//     act[l], act = lm_valid & seen in both cameras under that mask
//     (stereo_observability_mask), with m, act and their counts.
//
// What bounds it on the H100: neither. At the solves' shapes (W=10,
// L=256, with the gate) it reads ~60 KB (obs, mask, weights) and writes
// ~420 KB (H_pl of both sets dominates), ~0.14 us at 3.35 TB/s, the larger
// of its two bounds; its ~3.9 M fp operations take ~0.06 us at 67 TFLOP/s.
// What it costs (~0.02 ms) is its two launches and the latency of each
// warp's chain of loads, arithmetic and shuffles.
//
// Design:
//   - One warp per landmark, its lanes over the 2W (w, c) observations
//     (lane = 2w + c, so W <= 16): a landmark's observations are all in one
//     warp, so act is a __ballot_sync and H_ll / g_l a 5-step
//     __shfl_xor_sync butterfly, written straight from registers; H_pl[w,l]
//     adds the two lanes of pose w (one shuffle) and r_sq, m, H_pl leave
//     from the lane that made them.
//   - The pose blocks (H_pp's upper triangle, g_p, the cost: 28 numbers a
//     pose and set) are summed over the block's warps in shared memory in
//     a fixed order into one partial per block, and a second one-block
//     launch sums the partials in block order. Every sum has a fixed
//     order and there are no atomics: two runs give the same bits.
//   - A template on float / double: the solve runs in the caller's dtype.
//     Built with --fmad=false (ops/cuda/build.py), so each product and sum
//     rounds as in the plain version, which differs only in the order of
//     its sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // landmarks a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxW = 16;                 // lanes 2w + c of one warp
constexpr int kPoseQ = 28;                // H_pp upper (21), g_p (6), cost
constexpr int kCost = 27;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float mag(float x) { return fabsf(x); }
__device__ __forceinline__ double mag(double x) { return fabs(x); }

template <typename T>
struct Args {
  const T* T_B_W;       // (W,4,4)
  const T* T_C_B;       // (2,4,4)
  const T* lms;         // (L,3)
  const T* obs;         // (W,2,L,2)
  const uint8_t* mask;  // (W,2,L)
  const T* weight;      // (W,L) sqrt-weights, or null
  const uint8_t* lm_valid;  // (L,)
  int W, L, sets;       // sets: 1, or 2 with the gate
  T delta, half_delta, gate_sq, cheirality;
  // Outputs, [set]: the per-landmark blocks, written by the first kernel.
  T* H_ll[2];           // (L,3,3)
  T* g_l[2];            // (L,3)
  T* H_pl[2];           // (W,L,6,3)
  T* r_sq;              // (W,2,L)
  uint8_t* m;           // (W,2,L) gated mask
  uint8_t* act;         // (L,) gated landmark set
  T* partial;           // (blocks, sets, W, kPoseQ)
  long long* count_partial;  // (blocks, 2): gated observations, landmarks
};

// One observation's whitened linearization, as linearize_projection and
// apply_obs_weights compute it.
template <typename T>
struct Lin {
  T Jp[2][6], Jl[2][3], r[2], cost;
};

template <typename T>
__device__ void linearize(const Args<T>& a, int w, int c, int l,
                          bool on, Lin<T>& o) {
  const T* Tb = a.T_B_W + 16 * w;
  const T* Tc = a.T_C_B + 16 * c;
  const T p0 = a.lms[3 * l], p1 = a.lms[3 * l + 1], p2 = a.lms[3 * l + 2];
  T pB[3], pC[3], RR[3][3];
  for (int i = 0; i < 3; ++i)
    pB[i] = Tb[4 * i] * p0 + Tb[4 * i + 1] * p1 + Tb[4 * i + 2] * p2
            + Tb[4 * i + 3];
  for (int i = 0; i < 3; ++i) {
    pC[i] = Tc[4 * i] * pB[0] + Tc[4 * i + 1] * pB[1] + Tc[4 * i + 2] * pB[2]
            + Tc[4 * i + 3];
    for (int j = 0; j < 3; ++j)
      RR[i][j] = Tc[4 * i] * Tb[j] + Tc[4 * i + 1] * Tb[4 + j]
                 + Tc[4 * i + 2] * Tb[8 + j];
  }
  const bool front = pC[2] > T(1e-6);
  const T mf = on ? T(1) : T(0);
  const T valid = (on && front) ? T(1) : T(0);
  const size_t ob = ((size_t)(2 * w + c) * a.L + l) * 2;
  T r0 = T(0), r1 = T(0);
  if (on) {
    if (front) {
      r0 = pC[0] / pC[2] - a.obs[ob];
      r1 = pC[1] / pC[2] - a.obs[ob + 1];
    } else {
      r0 = r1 = a.cheirality;
    }
  }
  // proj_jacobian: 1/z with |z| floored at 1e-9.
  const T zs = mag(pC[2]) > T(1e-9) ? pC[2] : T(1e-9);
  const T iz = T(1) / zs;
  const T iz2 = iz * iz;
  const T ax = -pC[0] * iz2, ay = -pC[1] * iz2;
  // RR @ (-hat(p_W)).
  T M[3][3];
  for (int i = 0; i < 3; ++i) {
    M[i][0] = RR[i][1] * (-p2) + RR[i][2] * p1;
    M[i][1] = RR[i][0] * p2 + RR[i][2] * (-p0);
    M[i][2] = RR[i][0] * (-p1) + RR[i][1] * p0;
  }
  T Jt[2][3], Jw[2][3], Jl[2][3];
  for (int j = 0; j < 3; ++j) {
    Jt[0][j] = iz * Tc[j] + ax * Tc[8 + j];
    Jt[1][j] = iz * Tc[4 + j] + ay * Tc[8 + j];
    Jw[0][j] = iz * M[0][j] + ax * M[2][j];
    Jw[1][j] = iz * M[1][j] + ay * M[2][j];
    Jl[0][j] = iz * RR[0][j] + ax * RR[2][j];
    Jl[1][j] = iz * RR[1][j] + ay * RR[2][j];
  }
  // Huber on the unweighted residual; sw = sqrt(w_huber) * valid scales r
  // and J, then the sqrt-weight ow (cost by ow^2), in the plain version's
  // order of roundings.
  const T rs = (r0 * r0 + r1 * r1) * mf;
  const T rn = root(rs > T(1e-18) ? rs : T(1e-18));
  const bool inside = rn <= a.delta;
  const T sw = root(inside ? T(1) : a.delta / rn) * valid;
  T cost = (inside ? T(0.5) * rs : a.delta * (rn - a.half_delta)) * mf;
  const bool weighted = a.weight != nullptr;
  const T ow = weighted ? a.weight[(size_t)w * a.L + l] : T(1);
  o.r[0] = r0 * sw;
  o.r[1] = r1 * sw;
  for (int rr = 0; rr < 2; ++rr)
    for (int j = 0; j < 3; ++j) {
      o.Jp[rr][j] = Jt[rr][j] * sw;
      o.Jp[rr][3 + j] = Jw[rr][j] * sw;
      o.Jl[rr][j] = Jl[rr][j] * sw;
    }
  if (weighted) {
    o.r[0] = o.r[0] * ow;
    o.r[1] = o.r[1] * ow;
    for (int rr = 0; rr < 2; ++rr) {
      for (int j = 0; j < 6; ++j) o.Jp[rr][j] = o.Jp[rr][j] * ow;
      for (int j = 0; j < 3; ++j) o.Jl[rr][j] = o.Jl[rr][j] * ow;
    }
    cost = cost * (ow * ow);
  }
  o.cost = cost;
}

// Sum over the lanes of pose w (lanes 2w, 2w + 1): both lanes get the
// same bits.
template <typename T>
__device__ __forceinline__ T pair_sum(T v) {
  return v + __shfl_xor_sync(kFull, v, 1);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One set's blocks from one lane's linearization (scaled by f: 1, or the
// gate's 0 / 1, as the plain version masks its terms): H_pl, H_ll and g_l
// written, the pose numbers left in sm[warp][pose][.] for the block's sum.
template <typename T>
__device__ void emit(const Args<T>& a, int set, const Lin<T>& lin, T f,
                     int w, int c, int l, bool lane_on, bool lm_on,
                     T (*sm)[kMaxW][kPoseQ], int warp) {
  T Jp[2][6], Jl[2][3], r[2];
  for (int rr = 0; rr < 2; ++rr) {
    for (int i = 0; i < 6; ++i) Jp[rr][i] = lin.Jp[rr][i] * f;
    for (int i = 0; i < 3; ++i) Jl[rr][i] = lin.Jl[rr][i] * f;
    r[rr] = lin.r[rr] * f;
  }
  const T cost = lin.cost * f;
  if (!lane_on) {
    for (int rr = 0; rr < 2; ++rr) {
      for (int i = 0; i < 6; ++i) Jp[rr][i] = T(0);
      for (int i = 0; i < 3; ++i) Jl[rr][i] = T(0);
      r[rr] = T(0);
    }
  }
  // H_pl[w, l]: this lane's J_pose^T J_lm plus its partner camera's.
  T* hpl = a.H_pl[set] + ((size_t)w * a.L + l) * 18;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) {
      T v = pair_sum(Jp[0][i] * Jl[0][j] + Jp[1][i] * Jl[1][j]);
      if (lm_on && lane_on && c == 0) hpl[3 * i + j] = v;
    }
  // H_ll[l], g_l[l] over every observation of the landmark.
  T hll[6], gl[3];
  int k = 0;
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j)
      hll[k++] = warp_sum(Jl[0][i] * Jl[0][j] + Jl[1][i] * Jl[1][j]);
  for (int i = 0; i < 3; ++i)
    gl[i] = warp_sum(Jl[0][i] * r[0] + Jl[1][i] * r[1]);
  const int lane = threadIdx.x & 31;
  if (lm_on && lane == 0) {
    T* h = a.H_ll[set] + (size_t)l * 9;
    k = 0;
    for (int i = 0; i < 3; ++i)
      for (int j = i; j < 3; ++j, ++k) {
        h[3 * i + j] = hll[k];
        h[3 * j + i] = hll[k];
      }
    for (int i = 0; i < 3; ++i) a.g_l[set][(size_t)l * 3 + i] = gl[i];
  }
  // The pose numbers of pose w, summed over its two cameras.
  T q[kPoseQ];
  k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j)
      q[k++] = Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j];
  for (int i = 0; i < 6; ++i) q[k++] = Jp[0][i] * r[0] + Jp[1][i] * r[1];
  q[kCost] = lane_on ? cost : T(0);
  for (int i = 0; i < kPoseQ; ++i) q[i] = pair_sum(q[i]);
  // Every lane pair writes its own slot (zeros past the window's poses and
  // in a warp without a landmark), so the block sum reads no stale slot.
  if (c == 0)
    for (int i = 0; i < kPoseQ; ++i) sm[warp][lane >> 1][i] = q[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ba_assemble_kernel(const Args<T> a) {
  __shared__ T sm[kWarps][kMaxW][kPoseQ];
  __shared__ long long counts[kWarps][2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = lane >> 1, c = lane & 1;
  const int l = blockIdx.x * kWarps + warp;
  const bool lm_on = l < a.L;
  const bool lane_on = lm_on && w < a.W;
  const int ll = lm_on ? l : 0;
  const int ww = lane_on ? w : 0;

  const bool on = lane_on && a.mask[((size_t)(2 * ww + c)) * a.L + ll] != 0;
  Lin<T> lin = {};
  if (lm_on) linearize(a, ww, c, ll, on, lin);
  const T r_sq = lin.r[0] * lin.r[0] + lin.r[1] * lin.r[1];
  if (lane_on) a.r_sq[((size_t)(2 * w + c)) * a.L + l] = r_sq;

  emit(a, 0, lin, T(1), ww, c, ll, lane_on, lm_on, sm, warp);
  for (int s = 0; s < a.sets; ++s) {
    if (s == 1) {
      // The gated set: m = mask & (r_sq <= gate^2), then & act[l].
      bool m = on && r_sq <= a.gate_sq;
      const unsigned b = __ballot_sync(kFull, m);
      const bool act = lm_on && a.lm_valid[ll] != 0
                       && (b & 0x55555555u) != 0 && (b & 0xaaaaaaaau) != 0;
      m = m && act;
      const unsigned bm = __ballot_sync(kFull, m);
      if (lane_on) a.m[((size_t)(2 * w + c)) * a.L + l] = m ? 1 : 0;
      if (lm_on && lane == 0) a.act[l] = act ? 1 : 0;
      if (lane == 0) {
        counts[warp][0] = __popc(bm);
        counts[warp][1] = act ? 1 : 0;
      }
      emit(a, 1, lin, m ? T(1) : T(0), ww, c, ll, lane_on, lm_on, sm, warp);
    }
    __syncthreads();
    // The block's partial: its warps' pose numbers in warp order.
    T* out = a.partial + ((size_t)blockIdx.x * a.sets + s) * a.W * kPoseQ;
    for (int e = threadIdx.x; e < a.W * kPoseQ; e += kThreads) {
      const int pw = e / kPoseQ, q = e % kPoseQ;
      T v = T(0);
      for (int k = 0; k < kWarps; ++k) v += sm[k][pw][q];
      out[e] = v;
    }
    if (s == 1 && threadIdx.x < 2) {
      long long v = 0;
      for (int k = 0; k < kWarps; ++k) v += counts[k][threadIdx.x];
      a.count_partial[2 * (size_t)blockIdx.x + threadIdx.x] = v;
    }
    __syncthreads();
  }
}

// The pose blocks: each pose number summed over the blocks' partials in
// block order, a thread each; the cost then over the poses in order. One
// block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ba_reduce_kernel(const T* partial, const long long* count_partial,
                 int blocks, int W, int sets, T* H_pp0, T* H_pp1, T* g_p0,
                 T* g_p1, T* cost0, T* cost1, long long* counts) {
  __shared__ T pose_cost[2][kMaxW];
  for (int e = threadIdx.x; e < sets * W * kPoseQ; e += kThreads) {
    const int s = e / (W * kPoseQ), pw = (e / kPoseQ) % W, q = e % kPoseQ;
    const T* p = partial + ((size_t)s * W + pw) * kPoseQ + q;
    const size_t stride = (size_t)sets * W * kPoseQ;
    T v = T(0);
#pragma unroll 8
    for (int b = 0; b < blocks; ++b) v += p[b * stride];
    if (q == kCost) {
      pose_cost[s][pw] = v;
    } else if (q < 21) {
      int i = 0, k = q;
      while (k >= 6 - i) {
        k -= 6 - i;
        ++i;
      }
      const int j = i + k;
      T* H_pp = s ? H_pp1 : H_pp0;
      H_pp[pw * 36 + 6 * i + j] = v;
      H_pp[pw * 36 + 6 * j + i] = v;
    } else {
      (s ? g_p1 : g_p0)[pw * 6 + (q - 21)] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < sets) {
    T v = T(0);
    for (int i = 0; i < W; ++i) v += pose_cost[threadIdx.x][i];
    *(threadIdx.x ? cost1 : cost0) = v;
  } else if (sets == 2 && threadIdx.x >= 32 && threadIdx.x < 34) {
    const int k = threadIdx.x - 32;
    long long v = 0;
#pragma unroll 8
    for (int b = 0; b < blocks; ++b) v += count_partial[2 * b + k];
    counts[k] = v;
  }
}

template <typename T>
int launch(const void* T_B_W, const void* T_C_B, const void* lms,
           const void* obs, const uint8_t* mask, const void* weight,
           const uint8_t* lm_valid, int W, int L, double delta,
           double gate_sq, double cheirality, int gated, void* const* out,
           void* stream) {
  Args<T> a;
  a.T_B_W = (const T*)T_B_W;
  a.T_C_B = (const T*)T_C_B;
  a.lms = (const T*)lms;
  a.obs = (const T*)obs;
  a.mask = mask;
  a.weight = (const T*)weight;
  a.lm_valid = lm_valid;
  a.W = W;
  a.L = L;
  a.sets = gated ? 2 : 1;
  a.delta = (T)delta;
  a.half_delta = (T)(0.5 * delta);
  a.gate_sq = (T)gate_sq;
  a.cheirality = (T)cheirality;
  // out: H_pp, g_p, H_ll, g_l, H_pl, cost of set 0, the same of set 1,
  // r_sq, m, act, counts, partial, count_partial.
  T* H_pp[2] = {(T*)out[0], (T*)out[6]};
  T* g_p[2] = {(T*)out[1], (T*)out[7]};
  T* cost[2] = {(T*)out[5], (T*)out[11]};
  for (int s = 0; s < 2; ++s) {
    a.H_ll[s] = (T*)out[6 * s + 2];
    a.g_l[s] = (T*)out[6 * s + 3];
    a.H_pl[s] = (T*)out[6 * s + 4];
  }
  a.r_sq = (T*)out[12];
  a.m = (uint8_t*)out[13];
  a.act = (uint8_t*)out[14];
  long long* counts = (long long*)out[15];
  a.partial = (T*)out[16];
  a.count_partial = (long long*)out[17];
  const int blocks = L > 0 ? (L + kWarps - 1) / kWarps : 1;
  cudaStream_t st = (cudaStream_t)stream;
  ba_assemble_kernel<T><<<blocks, kThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ba_reduce_kernel<T><<<1, kThreads, 0, st>>>(
      a.partial, a.count_partial, blocks, W, a.sets, H_pp[0], H_pp[1],
      g_p[0], g_p[1], cost[0], cost[1], counts);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronize, allocates nothing, and returns a cudaError_t code, -1 for
// bad arguments. `out` holds 18 device pointers (see launch); the set-1
// pointers, m, act and counts may be null when `gated` is 0. `blocks`
// must be ba_assemble_blocks(L), the partials' leading dimension.
extern "C" int ba_assemble_blocks(int L) {
  return L > 0 ? (L + kWarps - 1) / kWarps : 1;
}

extern "C" int ba_assemble_launch(
    int f64, const void* T_B_W, const void* T_C_B, const void* lms,
    const void* obs, const uint8_t* mask, const void* weight,
    const uint8_t* lm_valid, int W, int L, double delta, double gate_sq,
    double cheirality, int gated, void* const* out, void* stream) {
  if (W < 1 || W > kMaxW || L < 0) return -1;
  if (f64)
    return launch<double>(T_B_W, T_C_B, lms, obs, mask, weight, lm_valid, W,
                          L, delta, gate_sq, cheirality, gated, out, stream);
  return launch<float>(T_B_W, T_C_B, lms, obs, mask, weight, lm_valid, W, L,
                       delta, gate_sq, cheirality, gated, out, stream);
}
