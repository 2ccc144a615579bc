// Correctly rounded float division by a number whose reciprocal is known,
// for nvcc and g++ alike.
//
// div_rn(a, b, inv_b), with inv_b = 1.0f / b correctly rounded, takes the
// product q = a * inv_b and corrects it once by the exact remainder
// a - b*q (an FMA): q + (a - b*q) * inv_b rounded once is the correctly
// rounded quotient a / b (Markstein's theorem), wherever a / b neither
// overflows nor underflows. Only the sign of a zero quotient may differ
// from a division: -0 / b gives +0. Three instructions and no reciprocal
// unit, against an IEEE division's reciprocal, refinement and range check.
// The tests compare it with a / b for every float b in [0.5, 4).

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define EXACT_DIV_FN __host__ __device__ __forceinline__
#else
#define EXACT_DIV_FN inline
#endif

namespace exact_div {

EXACT_DIV_FN float div_rn(float a, float b, float inv_b) {
  const float q = a * inv_b;
  return fmaf(fmaf(-b, q, a), inv_b, q);
}

}  // namespace exact_div

#undef EXACT_DIV_FN
