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
// What bounds it on an H100: arithmetic and registers, not memory. A fit
// reads 25 pixels (100 bytes) and writes 12 floats, then spends num_iters
// x 2 passes over the 25 pixels (an expf, the 7-entry Jacobian and the 28
// normal-matrix products each) plus a 7x7 Cholesky: ~10^5 flops per fit.
// The JAX version spreads the batch across TPU lanes and runs hundreds of
// (N,)-wide ops per iteration; run eagerly on a GPU that is a chain of
// thousands of tiny launches. Here every fit lives in one thread's
// registers (patch, parameters, bounds, normal matrix), so the whole
// loop is one launch with no intermediate device traffic; fits are
// independent, so there is no synchronisation. The normal matrix is
// accumulated pixel by pixel with the closed-form Jacobian instead of
// being stored. Built with -fmad=false and summing in pixel order, it
// matches its plain twin (ops/fused_fit.py) bit for bit.
// Measured on an NVIDIA H100 80GB HBM3 (700 W limit): 2.9 ms for 65,536
// fits x 40 iterations (theta_starts=1), 5.8 ms with the restart, against
// 0.68 s / 1.0 s for the eager twin; 166 registers, no spills, so about
// 12 warps per SM can be resident. Later work: occupancy (register
// count), reciprocals in place of the per-pixel IEEE divisions, and
// warp-level batching of the per-pixel passes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kDeg2Rad = 0.017453292519943295f;
constexpr float kLam0 = 1e-3f;
constexpr float kLamUp = 4.0f;
constexpr float kLamDown = 0.25f;
constexpr int kThreads = 128;

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Sum of squared residuals of the normalised model against data.
__device__ __forceinline__ float cost_of(const float p[7], const float d[25]) {
  const float rota = p[6] * kDeg2Rad;
  const float cs = cosf(rota), sn = sinf(rota);
  float cost = 0.0f;
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    const float dh = p[3] - static_cast<float>(k / 5);
    const float dw = p[2] - static_cast<float>(k % 5);
    const float u = (dh * cs - dw * sn) / p[4];
    const float v = (dh * sn + dw * cs) / p[5];
    const float e = expf(-(u * u + v * v) * 0.5f);
    const float r = (p[0] + p[1] * e) - d[k];
    cost += r * r;
  }
  return cost;
}

// One damped Gauss-Newton step with accept/reject, in place.
__device__ __forceinline__ void lm_step(float p[7], float& lam, float& cost, const float d[25],
                        const float lo[7], const float hi[7]) {
  const float rota = p[6] * kDeg2Rad;
  const float cs = cosf(rota), sn = sinf(rota);
  const float sh = p[4], sw = p[5];
  const float ratio = sw / sh - sh / sw;
  float g[7] = {0, 0, 0, 0, 0, 0, 0};
  float A[28];  // lower triangle, row-major: A[i*(i+1)/2 + j], j <= i
#pragma unroll
  for (int i = 0; i < 28; ++i) A[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    const float dh = p[3] - static_cast<float>(k / 5);
    const float dw = p[2] - static_cast<float>(k % 5);
    const float u = (dh * cs - dw * sn) / sh;
    const float v = (dh * sn + dw * cs) / sw;
    const float e = expf(-(u * u + v * v) * 0.5f);
    const float ae = p[1] * e;
    const float r = (p[0] + ae) - d[k];
    float J[7];
    J[0] = 1.0f;
    J[1] = e;
    J[2] = ae * (u * sn / sh - v * cs / sw);
    J[3] = -ae * (u * cs / sh + v * sn / sw);
    J[4] = ae * u * (u / sh);
    J[5] = ae * v * (v / sw);
    J[6] = kDeg2Rad * ae * u * v * ratio;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      g[i] += J[i] * r;
#pragma unroll
      for (int j = 0; j <= i; ++j) A[i * (i + 1) / 2 + j] += J[i] * J[j];
    }
  }
  // mpfit pegging: a parameter at a bound whose gradient pushes outward
  // loses its Jacobian column (row and column of A, entry of g).
  bool fr[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float eps_lo = fmaxf(fabsf(lo[i]), 1.0f) * 1e-7f;
    const float eps_hi = fmaxf(fabsf(hi[i]), 1.0f) * 1e-7f;
    const bool pegged = (p[i] <= lo[i] + eps_lo && g[i] > 0.0f) ||
                        (p[i] >= hi[i] - eps_hi && g[i] < 0.0f);
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
  for (int i = 0; i < 7; ++i) pn[i] = clipf(p[i] - x[i], lo[i], hi[i]);
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

__device__ __forceinline__ float lm_run(float p[7], const float d[25], const float lo[7],
                        const float hi[7], int num_iters) {
  float lam = kLam0;
  float cost = cost_of(p, d);
  for (int it = 0; it < num_iters; ++it) lm_step(p, lam, cost, d, lo, hi);
  return cost;
}

__global__ void __launch_bounds__(kThreads)
fit_quality_kernel(const float* __restrict__ images,
                   const int* __restrict__ hs, const int* __restrict__ ws,
                   int B, int H, int W, int K, int num_iters,
                   int theta_starts, float* __restrict__ params,
                   float* __restrict__ center_h, float* __restrict__ center_w,
                   float* __restrict__ rmse, float* __restrict__ r2,
                   float* __restrict__ s_n) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= static_cast<long long>(B) * K) return;
  const int b = static_cast<int>(n / K);
  const float* img = images + static_cast<size_t>(b) * H * W;
  const int h0 = hs[n], w0 = ws[n];

  // Gather. Centers lie 2 px inside the image; an index outside follows
  // the JAX gather (a negative one counts from the end, then clamps).
  float x[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    int yy = h0 + k / 5 - 2;
    int xx = w0 + k % 5 - 2;
    yy = min(max(yy < 0 ? yy + H : yy, 0), H - 1);
    xx = min(max(xx < 0 ? xx + W : xx, 0), W - 1);
    x[k] = img[static_cast<size_t>(yy) * W + xx];
  }

  // pflib init and bounds (raw units), then clip the start into the box.
  float amax = x[0], asum = 0.0f, scale = 0.0f;
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    amax = fmaxf(amax, x[k]);
    asum += x[k];
    scale = fmaxf(scale, fabsf(x[k]));
  }
  float med;
  {
    float v[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) v[k] = x[k];
#pragma unroll
    for (int rnd = 0; rnd < 25; ++rnd) {
#pragma unroll
      for (int i = rnd & 1; i < 24; i += 2) {
        const float lo_ = fminf(v[i], v[i + 1]);
        const float hi_ = fmaxf(v[i], v[i + 1]);
        v[i] = lo_;
        v[i + 1] = hi_;
      }
    }
    med = v[12];
  }
  const float amean = asum / 25.0f;
  scale = fmaxf(scale, 1e-12f);
  float lo[7] = {0.0f, (amax - amean) / 3.0f, 2.0f, 2.0f, 0.75f, 0.75f, 0.0f};
  float hi[7] = {kBig, kBig, 3.0f, 3.0f, 2.0f, 2.0f, 360.0f};
  float p0[7] = {med, amax, 2.5f, 2.5f, 1.0f, 1.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 7; ++i) p0[i] = clipf(p0[i], lo[i], hi[i]);

  // Normalise H and A (and their bounds) by max |x|.
  float d[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) d[k] = x[k] / scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    p0[i] /= scale;
    lo[i] /= scale;
    hi[i] /= scale;
  }

  float p[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) p[i] = p0[i];
  float cost = lm_run(p, d, lo, hi, num_iters);

  if (theta_starts > 1) {
    float q[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) q[i] = p0[i];
    q[4] = clipf(p0[5], lo[4], hi[4]);
    q[5] = clipf(p0[4], lo[5], hi[5]);
    q[6] = clipf(90.0f, lo[6], hi[6]);
    const float cost90 = lm_run(q, d, lo, hi, num_iters);
    if (cost90 < cost) {
#pragma unroll
      for (int i = 0; i < 7; ++i) p[i] = q[i];
    }
  }
  p[0] *= scale;
  p[1] *= scale;

  // Quality on the raw patch with the reference-convention model
  // (ops/gaussian.py::gauss2d_ref).
  const float rota = p[6] * kDeg2Rad;
  const float cs = cosf(rota), sn = sinf(rota);
  const float rcx = p[3] * cs - p[2] * sn;
  const float rcy = p[3] * sn + p[2] * cs;
  float ss_res = 0.0f, ss_tot = 0.0f;
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    const float hg = static_cast<float>(k / 5), wg = static_cast<float>(k % 5);
    const float xp = hg * cs - wg * sn;
    const float yp = hg * sn + wg * cs;
    const float a = (rcx - xp) / p[4];
    const float c = (rcy - yp) / p[5];
    const float fit = p[0] + p[1] * expf(-(a * a + c * c) / 2.0f);
    const float res = x[k] - fit;
    ss_res += res * res;
    const float dev = x[k] - amean;
    ss_tot += dev * dev;
  }
  // Illumina S/N over the 16-pixel edge ring (population std).
  float ring_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    const int r = k / 5, c = k % 5;
    if (r == 0 || r == 4 || c == 0 || c == 4) ring_sum += x[k];
  }
  const float ring_mean = ring_sum / 16.0f;
  float ring_var = 0.0f;
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    const int r = k / 5, c = k % 5;
    if (r == 0 || r == 4 || c == 0 || c == 4) {
      const float dv = x[k] - ring_mean;
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
