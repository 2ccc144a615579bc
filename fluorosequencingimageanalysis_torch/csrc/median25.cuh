// Median of 25 values with a selection network, for nvcc and g++ alike.
//
// The network is Devillard's 99-exchange median-of-25 ("Fast median
// search: an ANSI C implementation", 1998, opt_med25), with every exchange
// whose min or max is never read again cut to the one half that is: 75
// full exchanges, 12 min-only, 12 max-only, 174 min/max in all (a full
// odd-even transposition sort of 25 values takes 600). It is exact for any
// ordered type: the result is one of the inputs.
//
// ``Ops`` supplies ``lo`` and ``hi`` (the min and max of two values). The
// kernels use ``FloatMinMax``; the tests prove the network over all 2^25
// zero-one inputs with bitwise AND / OR on 64 inputs at a time (the 0-1
// principle: a comparator network that selects the median of every 0-1
// input selects it for every input).

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define MEDIAN25_FN __host__ __device__ __forceinline__
#else
#define MEDIAN25_FN inline
#endif

namespace median25 {

struct FloatMinMax {
  static MEDIAN25_FN float lo(float a, float b) { return fminf(a, b); }
  static MEDIAN25_FN float hi(float a, float b) { return fmaxf(a, b); }
};

// The median of v[0..24]; v is left partly ordered.
template <class Ops, class T>
MEDIAN25_FN T select(T v[25]) {
#define CS(i, j)                           \
  {                                        \
    const T lo_ = Ops::lo(v[i], v[j]);     \
    v[j] = Ops::hi(v[i], v[j]);            \
    v[i] = lo_;                            \
  }
#define LO(i, j) v[i] = Ops::lo(v[i], v[j]);
#define HI(i, j) v[j] = Ops::hi(v[i], v[j]);
  // Sort triples and pairs.
  CS(0, 1) CS(3, 4) CS(2, 4) CS(2, 3) CS(6, 7) CS(5, 7) CS(5, 6) CS(9, 10)
  CS(8, 10) CS(8, 9) CS(12, 13) CS(11, 13) CS(11, 12) CS(15, 16) CS(14, 16)
  CS(14, 15) CS(18, 19) CS(17, 19) CS(17, 18) CS(21, 22) CS(20, 22)
  CS(20, 21) CS(23, 24)
  // Merge into sorted groups.
  CS(2, 5) CS(3, 6) CS(0, 6) CS(0, 3) CS(4, 7) CS(1, 7) CS(1, 4) CS(11, 14)
  CS(8, 14) CS(8, 11) CS(12, 15) CS(9, 15) CS(9, 12) CS(13, 16) CS(10, 16)
  CS(10, 13) CS(20, 23) CS(17, 23) CS(17, 20) CS(21, 24) CS(18, 24)
  CS(18, 21) CS(19, 22)
  // Discard the extremes and narrow down to the median.
  HI(8, 17) CS(9, 18) CS(0, 18) HI(0, 9) CS(10, 19) CS(1, 19) CS(1, 10)
  CS(11, 20) CS(2, 20) HI(2, 11) CS(12, 21) CS(3, 21) CS(3, 12) CS(13, 22)
  LO(4, 22) CS(4, 13) CS(14, 23) CS(5, 23) CS(5, 14) CS(15, 24) LO(6, 24)
  CS(6, 15) LO(7, 16) LO(7, 19) LO(13, 21) LO(15, 23) LO(7, 13) LO(7, 15)
  HI(1, 9) HI(3, 11) HI(5, 17) HI(11, 17) HI(9, 17) CS(4, 10) CS(6, 12)
  CS(7, 14) CS(4, 6) HI(4, 7) CS(12, 14) LO(10, 14) CS(6, 7) CS(10, 12)
  CS(6, 10) HI(6, 17) CS(12, 17) LO(7, 17) CS(7, 10) CS(12, 18) HI(7, 12)
  LO(10, 18) CS(12, 20) LO(10, 20) HI(10, 12)
#undef CS
#undef LO
#undef HI
  return v[12];
}

}  // namespace median25

#undef MEDIAN25_FN
