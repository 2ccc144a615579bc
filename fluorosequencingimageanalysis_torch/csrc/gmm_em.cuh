// One point's E-step and one component's M-step of the batched 1D
// Gaussian-mixture EM, for nvcc and g++ alike.
//
// A model of K components (K a compile-time bound; a component may be
// inactive) holds per component
//   cst = log(max(w, 1e-30)) - 0.5 * (log(var) + log(2 pi)),  mu,  var.
// For a point x the E-step takes, over the active components,
//   logp = cst - ((0.5 * (x - mu)) * (x - mu)) / var,
// their maximum m (0 where it is not finite), s = sum of exp(logp - m) in
// component order, lse = log(s) + m, and resp = exp(logp - lse).
// Inactive components have responsibility exactly 0, as in the plain
// twin, where their log-weight is -1e30 and exp(-1e30 - lse) is 0.
//
// This is the arithmetic of ops/gmm_batch.py::responsibilities and
// ::m_step operation for operation (the JAX package's _em_batched,
// ops/gmm_batch.py:53-108 there). The CPU tests build this header with g++
// (-ffp-contract=off) and hold it against those two functions bit for bit,
// with a stand-in for exp and log on both sides; kernel E keeps nvcc's FMA
// contraction and its expf/logf, and is held against the twin on the card
// within a stated tolerance.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define GMM_FN __host__ __device__ __forceinline__
#else
#define GMM_FN inline
#endif

namespace gmm {

constexpr float LOG_2PI = 1.8378770664093453f;
constexpr int KMAX = 8;  // the largest component count kernel E takes

template <int K>
struct Model {
  float cst[K];
  float mu[K];
  float var[K];
  bool act[K];
};

// A model's per-round constants from its weights, means, variances and
// active mask.
template <int K, class Log>
GMM_FN void prepare(const float* w, const float* mu, const float* var,
                    const bool* act, Log log_fn, Model<K>* m) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float logw = act[k] ? log_fn(fmaxf(w[k], 1e-30f)) : -1e30f;
    m->cst[k] = logw - 0.5f * (log_fn(var[k]) + LOG_2PI);
    m->mu[k] = mu[k];
    m->var[k] = var[k];
    m->act[k] = act[k];
  }
}

// The E-step of point x: returns lse and writes the K responsibilities.
template <int K, class Exp, class Log>
GMM_FN float point(const Model<K>& m, float x, Exp exp_fn, Log log_fn,
                   float* resp) {
  float logp[K];
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!m.act[k]) continue;
    const float d = x - m.mu[k];
    float q = 0.5f * d;
    q = q * d;
    q = q / m.var[k];
    logp[k] = m.cst[k] - q;
    mx = fmaxf(mx, logp[k]);
  }
  if (!isfinite(mx)) mx = 0.0f;
  float s = 0.0f;
  bool first = true;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!m.act[k]) continue;
    const float e = exp_fn(logp[k] - mx);
    s = first ? e : s + e;
    first = false;
  }
  const float lse = log_fn(s) + mx;
#pragma unroll
  for (int k = 0; k < K; ++k)
    resp[k] = m.act[k] ? exp_fn(logp[k] - lse) : 0.0f;
  return lse;
}

// One component's M-step from its statistics over the n valid points:
// its mean, its variance (floored at reg) and its weight before the
// weights are normalised (0 for an inactive component).
GMM_FN void component_update(float nk, float sk, float qk, float n,
                             float reg, bool act, float* mu, float* var,
                             float* w_raw) {
  const float nk_safe = fmaxf(nk, 1e-10f);
  const float m = sk / nk_safe;
  *mu = m;
  *var = fmaxf(qk / nk_safe - m * m, 0.0f) + reg;
  *w_raw = act ? nk / n : 0.0f;
}

// The normalised weight of component k from the K raw weights (summed in
// component order), and the final mean and variance of an inactive
// component (0 and 1).
template <int K>
GMM_FN void component_finish(const float* w_raw, int k, bool act,
                             float* w, float* mu, float* var) {
  float tot = w_raw[0];
#pragma unroll
  for (int j = 1; j < K; ++j) tot = tot + w_raw[j];
  *w = w_raw[k] / fmaxf(tot, 1e-30f);
  if (!act) {
    *mu = 0.0f;
    *var = 1.0f;
  }
}

}  // namespace gmm

#undef GMM_FN
