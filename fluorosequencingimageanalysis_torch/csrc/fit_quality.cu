// Fused 5x5 patch gather + bounded Levenberg-Marquardt Gaussian fit +
// fit quality, one fit per thread.
//
// Replaces the XLA composition
//   fluorosequencingimageanalysis_tpu/models/detect.py :: _fit_quality_core
// i.e. ops/candidates.py::gather_patches -> ops/lm.py::fit_gaussians_batched
// -> ops/gaussian.py::gauss2d_image -> ops/quality.py::{r_squared, rmse,
// illumina_s_n}, with the same mpfit semantics step for step: pflib's
// init and bounds (median-of-25 background, (max - mean)/3 amplitude
// floor), max-abs normalisation of H and A, a fixed trip count, pegged
// Jacobian columns zeroed, a damping floor of max(1e-8 * max diag, 1e-12),
// an unrolled 7x7 Cholesky with pivots clamped at 1e-30, steps projected
// onto the box, accept iff the cost drops (lam * 0.25 / lam * 4, clamped
// to [1e-12, 1e12]), and the optional theta0 = 90 restart with swapped
// sigmas. The damping constants are ops/lm.py's defaults, the only values
// the detect path uses.
//
// What bounds it on an H100: the SM's float32 issue rate. A fit reads 25
// pixels and writes 12 floats, then spends num_iters x 2 passes over the
// 25 pixels (an expf, the 7-entry Jacobian and the 28 normal-matrix
// products in one, the trial cost in the other) plus a 7x7 Cholesky:
// ~1.4e5 flops per fit, 9.2 GFLOP for 65,536 fits x 40 iterations, 0.14 ms
// at 67 TFLOP/s; the ~10 MB of traffic is nothing beside it. Every fit
// lives in one thread (parameters, normal matrix and Cholesky factor in
// registers), so the loop is one launch with no intermediate device
// traffic and no synchronisation. Three things keep such a kernel from
// its issue rate: registers (above 128 a thread, fewer than 4 blocks of
// 128 fit an SM, and 65,536 fits take more than one wave), divisions (an
// IEEE division is a reciprocal, a refinement and a range check, and the
// model has ten per pixel and iteration) and code size (fully unrolled
// 25-pixel passes make a loop body of some 10^4 instructions).
//
// The design: (1) at most 128 registers (__launch_bounds__(128, 4)): 4
// blocks an SM, 528 slots for the 512 blocks of 65,536 fits, one wave;
// (2) the normalised patch in shared memory, one column per thread, so
// the pixel passes loop over rows with the 5 columns unrolled (a short
// loop body) and the raw patch is re-read from device memory (L1/L2 hits)
// for the quality pass instead of held in registers; (3) 1/sigma_h and
// 1/sigma_w once per pass, and every per-pixel quotient a/sigma as the
// product a * (1/sigma) plus one FMA correction by its remainder
// (exact_div.cuh): three instructions and no reciprocal unit, and still
// the correctly rounded quotient here (|a| < 2^10, sigma in [0.75, 2];
// only a zero's sign may differ, which no sum or step below can see), so
// the twin keeps its true divisions and the JAX package's arithmetic;
// (4) the 11 constant bounds and their pegging tolerances as compile-time
// constants, only lo[1] and hi[0] = hi[1] per fit; (5) dh*cos, dh*sin once
// per row and dw*sin, dw*cos once per column, the same rounded products as
// per pixel. Built with -fmad=false and summing in pixel order, it matches
// its plain twin bit for bit.
// Measured on an NVIDIA H100 80GB HBM3 (700 W limit), 65,536 fits x 40
// iterations: 0.62-0.71 ms (theta_starts=1), 19-22% of the 0.137 ms bound,
// and 1.18 ms with the restart (23% of 0.274 ms); 128 registers, no
// spills. PERF.md section 6 has the runs.

#include <cuda_runtime.h>
#include <math.h>

#include "exact_div.cuh"
#include "median25.cuh"

namespace {

using exact_div::div_rn;

constexpr float kBig = 1e30f;
constexpr float kDeg2Rad = 0.017453292519943295f;
constexpr float kLam0 = 1e-3f;
constexpr float kLamUp = 4.0f;
constexpr float kLamDown = 0.25f;
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // caps registers at 65536 / (4 * 128) = 128

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// pflib's bounds of the normalised parameters (H, A, h0, w0, sigma_h,
// sigma_w, theta) apart from lo[1] and hi[0] = hi[1], which vary per fit.
__host__ __device__ constexpr float lo_const(int i) {
  return (i == 2 || i == 3) ? 2.0f : (i == 4 || i == 5) ? 0.75f : 0.0f;
}
__host__ __device__ constexpr float hi_const(int i) {
  return (i == 2 || i == 3) ? 3.0f : (i == 4 || i == 5) ? 2.0f : 360.0f;
}
// mpfit's pegging tolerance around a bound b: max(|b|, 1) * 1e-7.
__host__ __device__ constexpr float peg_eps(float b) {
  const float m = b < 0.0f ? -b : b;
  return (m > 1.0f ? m : 1.0f) * 1e-7f;
}

struct Box {
  float lo1;   // amplitude floor (max - mean) / 3 / scale
  float hi01;  // kBig / scale
  __device__ __forceinline__ float lo(int i) const {
    return i == 1 ? lo1 : lo_const(i);
  }
  __device__ __forceinline__ float hi(int i) const {
    return i < 2 ? hi01 : hi_const(i);
  }
};

// What the model needs of p at every pixel: the rotation, the inverse
// sigmas and the per-column products of dw = p[2] - column.
struct Frame {
  float cs, sn, inv_sh, inv_sw;
  float wsn[5], wcs[5];
  __device__ __forceinline__ explicit Frame(const float p[7]) {
    const float rota = p[6] * kDeg2Rad;
    cs = cosf(rota);
    sn = sinf(rota);
    inv_sh = 1.0f / p[4];
    inv_sw = 1.0f / p[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float dw = p[2] - static_cast<float>(c);
      wsn[c] = dw * sn;
      wcs[c] = dw * cs;
    }
  }
};

// Sum of squared residuals of the normalised model against the patch d
// (pixel k at d[k * kThreads]).
__device__ __forceinline__ float cost_of(const float p[7], const float* d) {
  const Frame f(p);
  float cost = 0.0f;
#pragma unroll 1
  for (int r = 0; r < 5; ++r) {
    const float dh = p[3] - static_cast<float>(r);
    const float hcs = dh * f.cs, hsn = dh * f.sn;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float u = div_rn(hcs - f.wsn[c], p[4], f.inv_sh);
      const float v = div_rn(hsn + f.wcs[c], p[5], f.inv_sw);
      const float e = expf(-(u * u + v * v) * 0.5f);
      const float res = (p[0] + p[1] * e) - d[(r * 5 + c) * kThreads];
      cost += res * res;
    }
  }
  return cost;
}

// One damped Gauss-Newton step with accept/reject, in place.
__device__ __forceinline__ void lm_step(float p[7], float& lam, float& cost,
                                        const float* d, const Box& box) {
  const Frame f(p);
  const float sh = p[4], sw = p[5];
  const float ratio = sw / sh - sh / sw;
  float g[7] = {0, 0, 0, 0, 0, 0, 0};
  float A[28];  // lower triangle, row-major: A[i*(i+1)/2 + j], j <= i
#pragma unroll
  for (int i = 0; i < 28; ++i) A[i] = 0.0f;
#pragma unroll 1
  for (int r = 0; r < 5; ++r) {
    const float dh = p[3] - static_cast<float>(r);
    const float hcs = dh * f.cs, hsn = dh * f.sn;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float u = div_rn(hcs - f.wsn[c], sh, f.inv_sh);
      const float v = div_rn(hsn + f.wcs[c], sw, f.inv_sw);
      const float e = expf(-(u * u + v * v) * 0.5f);
      const float ae = p[1] * e;
      const float res = (p[0] + ae) - d[(r * 5 + c) * kThreads];
      float J[7];
      J[0] = 1.0f;
      J[1] = e;
      J[2] = ae * (div_rn(u * f.sn, sh, f.inv_sh) -
                   div_rn(v * f.cs, sw, f.inv_sw));
      J[3] = -ae * (div_rn(u * f.cs, sh, f.inv_sh) +
                    div_rn(v * f.sn, sw, f.inv_sw));
      J[4] = ae * u * div_rn(u, sh, f.inv_sh);
      J[5] = ae * v * div_rn(v, sw, f.inv_sw);
      J[6] = kDeg2Rad * ae * u * v * ratio;
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        g[i] += J[i] * res;
#pragma unroll
        for (int j = 0; j <= i; ++j) A[i * (i + 1) / 2 + j] += J[i] * J[j];
      }
    }
  }
  // mpfit pegging: a parameter at a bound whose gradient pushes outward
  // loses its Jacobian column (row and column of A, entry of g).
  bool fr[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float lo = box.lo(i), hi = box.hi(i);
    const bool pegged = (p[i] <= lo + peg_eps(lo) && g[i] > 0.0f) ||
                        (p[i] >= hi - peg_eps(hi) && g[i] < 0.0f);
    fr[i] = !pegged;
    if (pegged) g[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      if (!(fr[i] && fr[j])) A[i * (i + 1) / 2 + j] = 0.0f;
    }
  }
  float dmax = A[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) dmax = fmaxf(dmax, A[i * (i + 1) / 2 + i]);
  const float floor_ = fmaxf(1e-8f * dmax, 1e-12f);
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float di = A[i * (i + 1) / 2 + i];
    A[i * (i + 1) / 2 + i] = di + lam * fmaxf(di, floor_) + floor_;
  }
  // Cholesky A = L L^T, in place in the lower triangle.
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float s = A[i * (i + 1) / 2 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= A[i * (i + 1) / 2 + k] * A[i * (i + 1) / 2 + k];
    const float lii = sqrtf(fmaxf(s, 1e-30f));
    A[i * (i + 1) / 2 + i] = lii;
    const float inv_d = 1.0f / lii;
#pragma unroll
    for (int j = i + 1; j < 7; ++j) {
      float t = A[j * (j + 1) / 2 + i];
#pragma unroll
      for (int k = 0; k < i; ++k) t -= A[j * (j + 1) / 2 + k] * A[i * (i + 1) / 2 + k];
      A[j * (j + 1) / 2 + i] = t * inv_d;
    }
  }
  float y[7], x[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= A[i * (i + 1) / 2 + k] * y[k];
    y[i] = s / A[i * (i + 1) / 2 + i];
  }
#pragma unroll
  for (int i = 6; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 7; ++k) s -= A[k * (k + 1) / 2 + i] * x[k];
    x[i] = s / A[i * (i + 1) / 2 + i];
  }
  float pn[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) pn[i] = clipf(p[i] - x[i], box.lo(i), box.hi(i));
  const float new_cost = cost_of(pn, d);
  if (new_cost < cost) {
#pragma unroll
    for (int i = 0; i < 7; ++i) p[i] = pn[i];
    cost = new_cost;
    lam = fmaxf(lam * kLamDown, 1e-12f);
  } else {
    lam = fminf(lam * kLamUp, 1e12f);
  }
}

// Pixel k of the 5x5 patch centred on (h0, w0). Centers lie 2 px inside
// the image; an index outside follows the JAX gather (a negative one
// counts from the end, then clamps).
__device__ __forceinline__ float patch_pixel(const float* img, int H, int W,
                                             int h0, int w0, int k) {
  int yy = h0 + k / 5 - 2;
  int xx = w0 + k % 5 - 2;
  yy = min(max(yy < 0 ? yy + H : yy, 0), H - 1);
  xx = min(max(xx < 0 ? xx + W : xx, 0), W - 1);
  return img[static_cast<size_t>(yy) * W + xx];
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fit_quality_kernel(const float* __restrict__ images,
                   const int* __restrict__ hs, const int* __restrict__ ws,
                   int B, int H, int W, int K, int num_iters,
                   int theta_starts, float* __restrict__ params,
                   float* __restrict__ center_h, float* __restrict__ center_w,
                   float* __restrict__ rmse, float* __restrict__ r2,
                   float* __restrict__ s_n) {
  __shared__ float s_d[25 * kThreads];
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= static_cast<long long>(B) * K) return;
  const int b = static_cast<int>(n / K);
  const float* img = images + static_cast<size_t>(b) * H * W;
  const int h0 = hs[n], w0 = ws[n];
  float* d = s_d + threadIdx.x;

  // pflib init and bounds (raw units), then clip the start into the box.
  float amax, amean, scale, med;
  {
    float x[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) x[k] = patch_pixel(img, H, W, h0, w0, k);
    float asum = 0.0f;
    amax = x[0];
    scale = 0.0f;
#pragma unroll
    for (int k = 0; k < 25; ++k) {
      amax = fmaxf(amax, x[k]);
      asum += x[k];
      scale = fmaxf(scale, fabsf(x[k]));
    }
    amean = asum / 25.0f;
    scale = fmaxf(scale, 1e-12f);
    // Normalise the patch by max |x| (H and A and their bounds follow).
#pragma unroll
    for (int k = 0; k < 25; ++k) d[k * kThreads] = x[k] / scale;
    med = median25::select<median25::FloatMinMax>(x);
  }
  const float lo1_raw = (amax - amean) / 3.0f;
  const Box box{lo1_raw / scale, kBig / scale};
  const float h_start = clipf(med, 0.0f, kBig) / scale;
  const float a_start = clipf(amax, lo1_raw, kBig) / scale;

  // One start at theta0 = 0 and, for theta_starts > 1, one at theta0 = 90
  // with the sigma inits swapped (both 1, already inside the box); the
  // lower final cost wins.
  float p[7];
  float best_cost = 0.0f;
  const int starts = theta_starts > 1 ? 2 : 1;
#pragma unroll 1
  for (int s = 0; s < starts; ++s) {
    float q[7] = {h_start, a_start, 2.5f, 2.5f, 1.0f, 1.0f,
                  s == 0 ? 0.0f : 90.0f};
    float lam = kLam0;
    float cost = cost_of(q, d);
#pragma unroll 1
    for (int it = 0; it < num_iters; ++it) lm_step(q, lam, cost, d, box);
    if (s == 0 || cost < best_cost) {
#pragma unroll
      for (int i = 0; i < 7; ++i) p[i] = q[i];
      best_cost = cost;
    }
  }
  p[0] *= scale;
  p[1] *= scale;

  // Quality on the raw patch, re-read from device memory, with the
  // reference-convention model (ops/gaussian.py::gauss2d_ref).
  const float rota = p[6] * kDeg2Rad;
  const float cs = cosf(rota), sn = sinf(rota);
  const float rcx = p[3] * cs - p[2] * sn;
  const float rcy = p[3] * sn + p[2] * cs;
  float ss_res = 0.0f, ss_tot = 0.0f, ring_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    const float xk = patch_pixel(img, H, W, h0, w0, k);
    const float hg = static_cast<float>(k / 5), wg = static_cast<float>(k % 5);
    const float xp = hg * cs - wg * sn;
    const float yp = hg * sn + wg * cs;
    const float a = (rcx - xp) / p[4];
    const float c = (rcy - yp) / p[5];
    const float fit = p[0] + p[1] * expf(-(a * a + c * c) / 2.0f);
    const float res = xk - fit;
    ss_res += res * res;
    const float dev = xk - amean;
    ss_tot += dev * dev;
    const int row = k / 5, col = k % 5;
    if (row == 0 || row == 4 || col == 0 || col == 4) ring_sum += xk;
  }
  // Illumina S/N over the 16-pixel edge ring (population std).
  const float ring_mean = ring_sum / 16.0f;
  float ring_var = 0.0f;
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    const int row = k / 5, col = k % 5;
    if (row == 0 || row == 4 || col == 0 || col == 4) {
      const float dv = patch_pixel(img, H, W, h0, w0, k) - ring_mean;
      ring_var += dv * dv;
    }
  }

#pragma unroll
  for (int i = 0; i < 7; ++i) params[n * 7 + i] = p[i];
  center_h[n] = p[2] + static_cast<float>(h0) - 2.5f;
  center_w[n] = p[3] + static_cast<float>(w0) - 2.5f;
  r2[n] = 1.0f - ss_res / ss_tot;
  rmse[n] = sqrtf(ss_res / 25.0f);
  s_n[n] = (amax - ring_mean) / sqrtf(ring_var / 16.0f);
}

}  // namespace

// images: (B, H, W) float32; hs, ws: (B, K) int32; outputs: params
// (B*K, 7) and center_h, center_w, rmse, r2, s_n (B*K) float32, all
// contiguous on the current device. Returns cudaGetLastError().
extern "C" int fit_quality_launch(const float* images, const int* hs,
                                  const int* ws, int B, int H, int W, int K,
                                  int num_iters, int theta_starts,
                                  float* params, float* center_h,
                                  float* center_w, float* rmse, float* r2,
                                  float* s_n, void* stream) {
  const long long n = static_cast<long long>(B) * K;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  fit_quality_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      images, hs, ws, B, H, W, K, num_iters, theta_starts, params, center_h,
      center_w, rmse, r2, s_n);
  return static_cast<int>(cudaGetLastError());
}
