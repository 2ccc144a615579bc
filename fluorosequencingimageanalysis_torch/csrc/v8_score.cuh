// The v8 sequence walk of one trace, for nvcc and g++ alike.
//
// A trace of F frames scores every candidate fluor-count sequence s with
//   score_s = ((c[0][tab[s][0]] + c[1][tab[s][1]]) + ...) + c[F-1][tab[s][F-1]]
// (plain float32 adds, left to right in frame order); s is valid when none
// of its F looked-up (frame, value) pairs is marked invalid, its score is
// not NaN, and seq_ok[s] is set; its key is max(score_s, -1e30) when valid
// and -inf otherwise. The winner is the greatest key, the lowest s among
// equals.
//
// The walk reads ONE array per trace: ``mark`` gives an invalid (frame,
// value) pair a NaN in place of its contribution, so a sequence that looks
// one up gets a NaN score and needs no second lookup and no flag: a valid
// sequence never touches a marked entry, so its sum is the sum of the
// plain contributions, bit for bit. ``raw_score`` is the unmarked sum of
// one sequence, for the trace with no valid sequence at all (it reports
// sequence 0's).
//
// The table is walked by LANES lanes side by side, PACK sequences per lane
// and step: the table is stored frame-major (tab_t[f][s], rows padded to a
// multiple of PACK with sequences whose seq_ok is 0), so the PACK values of
// one frame are one aligned 32-bit word and the lanes of a warp read
// neighbouring words. ``walk_lane`` is one lane's share; ``beats`` orders
// two lanes' winners. v8_score.cu runs one lane per thread and reduces with
// shuffles; the CPU tests build this header with g++, run the lanes in a
// loop and hold the result against the plain PyTorch twin bit for bit.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define V8_FN __host__ __device__ __forceinline__
#else
#define V8_FN inline
#endif

namespace v8 {

constexpr int LANES = 32;  // lanes that share one trace
constexpr int PACK = 4;    // sequences per lane and step (bytes of a word)

struct Best {
  float key;  // greatest key so far; -inf while no valid sequence was seen
  int idx;    // its sequence
  float raw;  // its score before the -1e30 floor
};

V8_FN Best none() { return Best{-INFINITY, 0x7fffffff, 0.0f}; }

// A contribution as the walk reads it: NaN where the pair is invalid.
V8_FN float mark(float contrib, uint8_t invalid) {
  return invalid ? NAN : contrib;
}

// Valid sequences floor at a huge finite key, so they beat every invalid
// one even when their own score underflowed to -inf. A NaN score (a marked
// pair was looked up) is never valid.
V8_FN float key_of(float score, bool seq_ok) {
  return (seq_ok && score == score) ? fmaxf(score, -1e30f) : -INFINITY;
}

// (key, -idx) order: does a beat b?
V8_FN bool beats(const Best& a, const Best& b) {
  return a.key > b.key || (a.key == b.key && a.idx < b.idx);
}

V8_FN uint32_t word(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(reinterpret_cast<const unsigned int*>(p));
#else
  uint32_t w;
  memcpy(&w, p, sizeof w);
  return w;
#endif
}

// Lane ``lane``'s walk over sequences PACK*(lane + LANES*i) + j. c: the
// trace's F*nv marked contributions. tab_t: (F, S_pad) frame-major table,
// seq_ok: (S_pad,), S_pad a multiple of PACK. A strict ``>`` in rising s
// keeps the lowest s among equal keys.
V8_FN void walk_lane(const float* c, const uint8_t* tab_t,
                     const uint8_t* seq_ok, int F, int nv, int S_pad,
                     int lane, Best* best) {
  for (int s0 = PACK * lane; s0 < S_pad; s0 += PACK * LANES) {
    float acc[PACK];
    uint32_t w = word(tab_t + s0);
#pragma unroll
    for (int j = 0; j < PACK; ++j) acc[j] = c[(w >> (8 * j)) & 0xff];
    for (int f = 1; f < F; ++f) {
      w = word(tab_t + static_cast<size_t>(f) * S_pad + s0);
      const float* cf = c + f * nv;
#pragma unroll
      for (int j = 0; j < PACK; ++j)
        acc[j] = acc[j] + cf[(w >> (8 * j)) & 0xff];
    }
    const uint32_t ok = word(seq_ok + s0);
#pragma unroll
    for (int j = 0; j < PACK; ++j) {
      const float key = key_of(acc[j], ((ok >> (8 * j)) & 0xff) != 0);
      if (key > best->key) *best = Best{key, s0 + j, acc[j]};
    }
  }
}

// The unmarked score of sequence s, in the same order.
V8_FN float raw_score(const float* contrib, const uint8_t* tab_t, int F,
                      int nv, int S_pad, int s) {
  float acc = contrib[tab_t[s]];
  for (int f = 1; f < F; ++f)
    acc = acc + contrib[f * nv + tab_t[static_cast<size_t>(f) * S_pad + s]];
  return acc;
}

}  // namespace v8

#undef V8_FN
