// One point's E-step, one component's M-step and the split of a group's
// models into balanced subsets, for the batched 1D Gaussian-mixture EM of
// kernel E, for nvcc and g++ alike.
//
// A model of K components (K a compile-time bound in kernel E's register
// form, a runtime count in its shared-memory form; a component may be
// inactive) holds per component, from its weight w, mean mu and variance
// var, the constants of one round in the log2 domain:
//   cst = log(max(w, 1e-30)) - 0.5 * (log(var) + log(2 pi))
//         (-1e30 in place of the log-weight of an inactive component),
//   c2 = cst * log2(e),   h2 = 0.5 * log2(e) * (1 / var),   mu.
// For a point x the E-step takes, over the active components,
//   l2 = c2 - ((x - mu) * (x - mu)) * h2,
// their maximum m (0 where it is not finite), e = exp2(l2 - m), s = the
// sum of e in component order, lse = (log2(s) + m) * log(2) and
// resp = e * (1 / s). That is k + 1 special-function operations a point
// and model (k exp2 and one log2) and one reciprocal: no second
// exponential and no division per component; the one reciprocal of each
// variance is a round's, not a point's. Inactive components have
// responsibility exactly 0, as in the plain twin, where their constant is
// -1.44e30 and exp2 of it is 0.
//
// This is the arithmetic of ops/gmm_batch.py::responsibilities and
// ::m_step operation for operation; the JAX package's _em_batched
// (ops/gmm_batch.py:53-108 there) computes the same log-sum-exp in the
// natural-log domain with a second exp, and the twin is held against it
// at the CPU tests' tolerances. The CPU tests build this header with g++
// (-ffp-contract=off) and hold it against the twin bit for bit, with a
// stand-in for exp2 and log2 on both sides; kernel E keeps nvcc's FMA
// contraction and takes exp2, log2 and the reciprocal from the special
// function unit's approximate instructions (their error bounds are in
// gmm_em.cu), and is held against the twin on the card within a stated
// tolerance.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define GMM_FN __host__ __device__ __forceinline__
#else
#define GMM_FN inline
#endif

namespace gmm {

constexpr float LOG_2PI = 1.8378770664093453f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float HALF_LOG2E = 0.7213475204444817f;  // 0.5f * LOG2E, exact
constexpr float LN2 = 0.6931471805599453f;
constexpr int KREG = 8;     // the largest K of kernel E's register form
constexpr int KMAX = 256;   // the largest K kernel E takes

template <int K>
struct Model {
  float c2[K];
  float mu[K];
  float h2[K];
  bool act[K];
};

// One component's per-round constants c2 and h2 from its weight,
// variance and active flag.
template <class Log>
GMM_FN void component_constants(float w, float var, bool act, Log log_fn,
                                 float* c2, float* h2) {
  const float logw = act ? log_fn(fmaxf(w, 1e-30f)) : -1e30f;
  const float cst = logw - 0.5f * (log_fn(var) + LOG_2PI);
  *c2 = cst * LOG2E;
  *h2 = HALF_LOG2E * (1.0f / var);
}

// A model's per-round constants from its weights, means, variances and
// active mask.
template <int K, class Log>
GMM_FN void prepare(const float* w, const float* mu, const float* var,
                    const bool* act, Log log_fn, Model<K>* m) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    component_constants(w[k], var[k], act[k], log_fn, &m->c2[k], &m->h2[k]);
    m->mu[k] = mu[k];
    m->act[k] = act[k];
  }
}

// The E-step of point x: returns lse, and writes e (0 for an inactive
// component) and r = rcp_fn(s), so that resp = e * r. rcp_fn(s) is 1 / s
// (the twin's IEEE quotient; kernel E's rcp.approx).
template <int K, class Exp2, class Log2, class Rcp>
GMM_FN float point_terms(const Model<K>& m, float x, Exp2 exp2_fn,
                         Log2 log2_fn, Rcp rcp_fn, float* e, float* r) {
  float l2[K];
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!m.act[k]) continue;
    const float d = x - m.mu[k];
    l2[k] = m.c2[k] - (d * d) * m.h2[k];
    mx = fmaxf(mx, l2[k]);
  }
  if (!isfinite(mx)) mx = 0.0f;
  float s = 0.0f;
  bool first = true;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e[k] = m.act[k] ? exp2_fn(l2[k] - mx) : 0.0f;
    if (!m.act[k]) continue;
    s = first ? e[k] : s + e[k];
    first = false;
  }
  *r = rcp_fn(s);
  return (log2_fn(s) + mx) * LN2;
}

// The E-step of point x over a model's a active components, their
// constants compacted in component order (c2[j], mu[j], h2[j], j < a):
// returns lse and writes the shift mx and r = rcp_fn(s), the arithmetic of
// point_terms with each term's exponent computed again for the sum. A
// component's e is component_term(..., mx), so resp = e * r as above.
template <class Exp2, class Log2, class Rcp>
GMM_FN float point_norm(const float* c2, const float* mu, const float* h2,
                        int a, float x, Exp2 exp2_fn, Log2 log2_fn,
                        Rcp rcp_fn, float* mx_out, float* r) {
  float mx = -INFINITY;
  for (int j = 0; j < a; ++j) {
    const float d = x - mu[j];
    mx = fmaxf(mx, c2[j] - (d * d) * h2[j]);
  }
  if (!isfinite(mx)) mx = 0.0f;
  float s = 0.0f;
  for (int j = 0; j < a; ++j) {
    const float d = x - mu[j];
    const float e = exp2_fn((c2[j] - (d * d) * h2[j]) - mx);
    s = j == 0 ? e : s + e;
  }
  *mx_out = mx;
  *r = rcp_fn(s);
  return (log2_fn(s) + mx) * LN2;
}

// One active component's e at point x under the shift mx of point_norm.
template <class Exp2>
GMM_FN float component_term(float c2, float mu, float h2, float x, float mx,
                            Exp2 exp2_fn) {
  const float d = x - mu;
  return exp2_fn((c2 - (d * d) * h2) - mx);
}

// The E-step of point x: returns lse and writes the K responsibilities.
template <int K, class Exp2, class Log2, class Rcp>
GMM_FN float point(const Model<K>& m, float x, Exp2 exp2_fn, Log2 log2_fn,
                   Rcp rcp_fn, float* resp) {
  float e[K], r;
  const float lse = point_terms<K>(m, x, exp2_fn, log2_fn, rcp_fn, e, &r);
#pragma unroll
  for (int k = 0; k < K; ++k) resp[k] = m.act[k] ? e[k] * r : 0.0f;
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
GMM_FN void component_finish(const float* w_raw, int K, int k, bool act,
                             float* w, float* mu, float* var) {
  float tot = w_raw[0];
  for (int j = 1; j < K; ++j) tot = tot + w_raw[j];
  *w = w_raw[k] / fmaxf(tot, 1e-30f);
  if (!act) {
    *mu = 0.0f;
    *var = 1.0f;
  }
}

// The split of one group's B models into S subsets of at most mmax
// models (S * mmax >= B), each carrying about the same work: a model's
// work is its active component count plus 2 (the per-point log2,
// reciprocal and log-sum-exp). Longest first (by active count, then by
// model index), each model goes to the subset with the least work so far
// that has room (the lowest index at a tie); each pass over the models
// takes the largest count below the last pass's, so the passes are as
// many as the distinct counts, whatever K is. Writes subset[b] for every
// model, using load and size (S ints each) as scratch; returns 0, or -1
// when the subsets cannot hold the models. Every block of kernel E
// computes it for its group and keeps its own subset's models in model
// order.
GMM_FN int assign_subsets(const int* nact, int B, int S, int mmax,
                          int* load, int* size, int* subset) {
  if (S < 1 || mmax < 1 || static_cast<long long>(S) * mmax < B) return -1;
  for (int s = 0; s < S; ++s) load[s] = size[s] = 0;
  for (int cur = 0x7fffffff;;) {
    int a = -1;
    for (int b = 0; b < B; ++b)
      if (nact[b] < cur && nact[b] > a) a = nact[b];
    if (a < 0) break;
    for (int b = 0; b < B; ++b) {
      if (nact[b] != a) continue;
      int best = -1;
      for (int s = 0; s < S; ++s)
        if (size[s] < mmax && (best < 0 || load[s] < load[best])) best = s;
      subset[b] = best;
      load[best] += a + 2;
      size[best] += 1;
    }
    cur = a;
  }
  return 0;
}

}  // namespace gmm

#undef GMM_FN
