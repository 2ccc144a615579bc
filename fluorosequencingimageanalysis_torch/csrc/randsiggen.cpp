// randsiggen: batched Monte-Carlo fluorosequencing signal generator.
//
// This fills the native slot the reference documents but does not ship:
// MCsimlib.py:1823-1830 calls `randsiggen.random_signal(...)`
// (a C extension whose source the reference admits lives elsewhere,
// MCsimlib.py docstrings around line 1981). We implement the same
// error model — dud fluors, Edman-failure delays, head/tail photobleaching,
// exposure windowing — as a plain-C-ABI batch sampler so the hot Monte-Carlo
// loop runs at native speed while trie accumulation stays in Python.
//
// The model is the one in sim/signals.py:random_signal (itself the exact
// port of MCsimlib.py:863-1074); the two are statistically identical
// (independent RNG streams, same distributions). Tests validate
// distributional agreement.
//
// Exposed C ABI (ctypes-friendly, no CPython API):
//   rsg_random_signal_batch(head, tail, p, b, u,
//                           window_acids, window_positions, window_offsets,
//                           n_acids, batch_size, seed, max_len,
//                           out_positions, out_acids, out_lengths)
//
// Output layout: sample i's signal is the first out_lengths[i] entries of
// out_positions[i*max_len:...] / out_acids[i*max_len:...], sorted by
// position (ties by acid), deduplicated.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <string>
#include <utility>
#include <vector>

namespace {

struct Window {
  char acid;
  std::vector<int32_t> positions;       // exposure cycle numbers
  std::vector<int32_t> exposures_full;  // sorted set(positions ∪ positions-1)
};

// Inverse-CDF sample of the Edman-delay distribution: number of failures e
// before a gap of length d closes, P(e) = C(d-1+e, e) p^d (1-p)^e.
// Mirrors the accumulate-until-flat loop in sim/signals.py:50-63.
inline int sample_edman_delay(int d, double p, double r) {
  // Exact control-flow mirror of sim/signals.py:_sample_edman_delay —
  // including its stall semantics: the Python loop detects CDF
  // exhaustion one step LATE (the stall check happens at the top of the
  // next iteration, after e was already incremented), so a fully
  // underflowed p^d returns 1, not 0. The geometric decay of the term
  // (q < 1) guarantees termination without a guard counter, as in the
  // Python model.
  const double q = 1.0 - p;
  double term = std::pow(p, (double)d);  // _dp(d, 0, p)
  double cdf = 0.0, prev = -1.0;
  int e = 0;
  while (cdf - prev > 0.0) {
    prev = cdf;
    cdf += term;
    if (cdf >= r) return e;
    ++e;
    // _dp(d, e, p) = _dp(d, e-1, p) * q * (d-1+e) / e
    term *= q * (double)(d - 1 + e) / (double)e;
  }
  return e;
}

// Photobleach sampler over an exposure list: returns index k of the exposure
// at which the fluor bleaches, or -1 for "survives all exposures".
// Mirrors sim/signals.py:67-90: acc += exp(-b*k); bleach when
// acc * (1 - exp(-b)) >= r.
inline int sample_bleach(const std::vector<int32_t>& exposures, double b,
                         double r) {
  const double scale = 1.0 - std::exp(-b);
  double acc = 0.0;
  for (size_t k = 0; k < exposures.size(); ++k) {
    acc += std::exp(-b * (double)k);
    if (acc * scale >= r) return (int)k;
  }
  return -1;
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 if any sample overflowed max_len (overflowing
// samples are truncated and reported with length = -(true_len)).
int rsg_random_signal_batch(
    const char* head_c, const char* tail_c, double p, double b, double u,
    const char* window_acids, const int32_t* window_positions,
    const int32_t* window_offsets, int32_t n_acids, int32_t batch_size,
    uint64_t seed, int32_t max_len, int32_t* out_positions, char* out_acids,
    int32_t* out_lengths) {
  const std::string head0(head_c ? head_c : "");
  const std::string tail0(tail_c ? tail_c : "");

  std::vector<Window> windows((size_t)n_acids);
  for (int32_t a = 0; a < n_acids; ++a) {
    windows[a].acid = window_acids[a];
    for (int32_t j = window_offsets[a]; j < window_offsets[a + 1]; ++j)
      windows[a].positions.push_back(window_positions[j]);
    std::vector<int32_t> full;
    for (int32_t x : windows[a].positions) {
      full.push_back(x);
      full.push_back(x - 1);
    }
    std::sort(full.begin(), full.end());
    full.erase(std::unique(full.begin(), full.end()), full.end());
    windows[a].exposures_full = std::move(full);
  }

  std::mt19937_64 rng(seed ^ 0x9e3779b97f4a7c15ULL);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  int rc = 0;

  std::string head, tail;
  std::vector<std::pair<int32_t, char>> gaps, drops;
  std::vector<int32_t> expo;

  for (int32_t s = 0; s < batch_size; ++s) {
    head = head0;
    tail = tail0;
    // Dud removal: each labeled occurrence dies independently w.p. u.
    if (u > 0.0) {
      for (const Window& w : windows) {
        for (char& c : head)
          if (c == w.acid && unif(rng) <= u) c = 'x';
        for (char& c : tail)
          if (c == w.acid && unif(rng) <= u) c = 'x';
      }
    }

    // Ideal cumulative gaps of live labeled head acids (1-based positions).
    gaps.clear();
    for (size_t i = 0; i < head.size(); ++i) {
      for (const Window& w : windows) {
        if (head[i] == w.acid) {
          gaps.emplace_back((int32_t)i + 1, head[i]);
          break;
        }
      }
    }
    std::sort(gaps.begin(), gaps.end());

    // Edman delays: cumulative over successive gaps.
    drops.clear();
    int32_t cumulative_e = 0, prev_pos = 0;
    for (const auto& g : gaps) {
      int d = g.first - prev_pos;
      prev_pos = g.first;
      cumulative_e += sample_edman_delay(d, p, unif(rng));
      drops.emplace_back(g.first + cumulative_e, g.second);
    }

    // Head photobleaching: exposures strictly before the delayed drop.
    for (auto& g : drops) {
      const Window* w = nullptr;
      for (const Window& cand : windows)
        if (cand.acid == g.second) { w = &cand; break; }
      expo.clear();
      for (int32_t x : w->exposures_full)
        if (x < g.first - 1) expo.push_back(x);
      int k = sample_bleach(expo, b, unif(rng));
      if (k >= 0) g.first = expo[(size_t)k] + 1;
    }

    // Tail photobleaching: tail fluors only ever appear via bleaching.
    for (const Window& w : windows) {
      int count = 0;
      for (char c : tail)
        if (c == w.acid) ++count;
      for (int t = 0; t < count; ++t) {
        int k = sample_bleach(w.exposures_full, b, unif(rng));
        if (k >= 0) drops.emplace_back(w.exposures_full[(size_t)k] + 1, w.acid);
      }
    }

    // Windowing: keep drops bounded by two exposures of their color.
    auto keep = [&](const std::pair<int32_t, char>& g) {
      for (const Window& w : windows) {
        if (w.acid != g.second) continue;
        return std::binary_search(w.exposures_full.begin(),
                                  w.exposures_full.end(), g.first) &&
               std::binary_search(w.exposures_full.begin(),
                                  w.exposures_full.end(), g.first - 1);
      }
      return false;
    };
    std::sort(drops.begin(), drops.end());
    drops.erase(std::unique(drops.begin(), drops.end()), drops.end());

    int32_t n_out = 0;
    int32_t true_len = 0;
    for (const auto& g : drops) {
      if (!keep(g)) continue;
      ++true_len;
      if (n_out < max_len) {
        out_positions[(size_t)s * max_len + n_out] = g.first;
        out_acids[(size_t)s * max_len + n_out] = g.second;
        ++n_out;
      }
    }
    if (true_len > max_len) {
      out_lengths[s] = -true_len;
      rc = -1;
    } else {
      out_lengths[s] = n_out;
    }
  }
  return rc;
}

}  // extern "C"
