// The Monte-Carlo random-search fit of one candidate, for nvcc and g++ alike.
//
// For a 25-pixel patch already normalised to [0, 1] and sampled 6-vectors
// (H, A, h0, w0, sh, sw), one sample's model on the 5x5 grid is
//   g[i][j] = A * exp(-((i - h0)^2 + (j - w0)^2) / (2 * sh^2)) + H
// (circular: sw rides along unused, pflib.py:93-115), divided by its largest
// pixel; its norm is sqrt of the sum over pixels of (patch - g)^2, summed in
// pixel order (h-major). The best sample is the first one whose norm is
// strictly below the running best, which starts at +inf: the earliest sample
// wins a tie, and a NaN norm never wins.
//
// Parity with the plain PyTorch twin (ops/mc_fit.py::mc_fit_plain) is by
// construction: every product and sum is rounded on its own (the kernel is
// built with -fmad=false, the harness with -ffp-contract=off), the pixel
// sum runs in the twin's order, the quotients are correctly rounded
// (exact_div::div_rn where its range holds, an IEEE division elsewhere),
// and exp is the caller's ``Exp`` (expf on the card, which is what torch's
// exp computes there). The CPU tests build this header with g++ and hold
// ``scan`` and ``better`` against the twin bit for bit.

#pragma once

#include <math.h>
#include <stddef.h>

#include "exact_div.cuh"

#ifdef __CUDACC__
#define MC_FN __host__ __device__ __forceinline__
#else
#define MC_FN inline
#endif

namespace mc {

constexpr int SIDE = 5;
constexpr int NPIX = SIDE * SIDE;
constexpr int NPARAM = 6;  // H, A, h0, w0, sh, sw

struct Best {
  float norm;           // +inf until a sample with a non-NaN norm is seen
  float p[NPARAM];      // its 6-vector; zeros while none
};

MC_FN Best none() {
  Best b;
  b.norm = INFINITY;
  #pragma unroll
  for (int i = 0; i < NPARAM; ++i) b.p[i] = 0.0f;
  return b;
}

// a / b correctly rounded. div_rn needs a quotient that neither overflows
// nor underflows: it decides where b lies in [1e-30, 1e6] and a is 0 or at
// least 1e-30 in size (so the quotient is 0 or above 1e-36); the IEEE
// division decides elsewhere (and for every NaN, inf and zero b).
MC_FN float quotient(float a, float b, float inv_b) {
  const bool in_range = b >= 1e-30f && b <= 1e6f &&
                        (a == 0.0f || fabsf(a) >= 1e-30f);
  return in_range ? exact_div::div_rn(a, b, inv_b) : a / b;
}

// One sample's norm against ``patch`` (NPIX floats, h-major).
template <class Exp>
MC_FN float sample_norm(const float* patch, float H, float A, float h0,
                        float w0, float sh, Exp exp_fn) {
  float a[SIDE], b[SIDE];
  #pragma unroll
  for (int i = 0; i < SIDE; ++i) {
    const float dh = (float)i - h0;
    const float dw = (float)i - w0;
    a[i] = dh * dh;
    b[i] = dw * dw;
  }
  const float den = 2.0f * (sh * sh);
  const float inv_den = 1.0f / den;
  float g[NPIX];
  float gmax = -INFINITY;
  #pragma unroll
  for (int i = 0; i < SIDE; ++i) {
    #pragma unroll
    for (int j = 0; j < SIDE; ++j) {
      const float t = -(a[i] + b[j]);
      const float e = exp_fn(quotient(t, den, inv_den));
      const float v = A * e + H;
      g[i * SIDE + j] = v;
      // A NaN pixel makes the norm NaN whatever the maximum is.
      gmax = fmaxf(gmax, v);
    }
  }
  const float inv_max = 1.0f / gmax;
  float acc = 0.0f;
  #pragma unroll
  for (int p = 0; p < NPIX; ++p) {
    const float d = patch[p] - quotient(g[p], gmax, inv_max);
    const float d2 = d * d;
    acc = p == 0 ? d2 : acc + d2;
  }
  return sqrtf(acc);
}

// Samples s0 <= s < s1 of candidate k; sample s's parameters are
// samples[q][s * K + k] for q = 0..5. ``best`` carries the running best.
template <class Exp, class Load>
MC_FN void scan(const float* patch, const float* const* samples, int K,
                int k, int s0, int s1, Exp exp_fn, Load load, Best* best) {
  for (int s = s0; s < s1; ++s) {
    const size_t o = (size_t)s * (size_t)K + (size_t)k;
    float q[NPARAM];
    #pragma unroll
    for (int i = 0; i < NPARAM; ++i) q[i] = load(samples[i] + o);
    const float n = sample_norm(patch, q[0], q[1], q[2], q[3], q[4], exp_fn);
    if (n < best->norm) {
      best->norm = n;
      #pragma unroll
      for (int i = 0; i < NPARAM; ++i) best->p[i] = q[i];
    }
  }
}

// Merging the bests of consecutive sample ranges in range order: a later
// range wins only with a strictly smaller norm, so the merge is the
// sequential scan's result.
MC_FN bool better(const Best& later, const Best& sofar) {
  return later.norm < sofar.norm;
}

}  // namespace mc

#undef MC_FN
