// Native batched Kerssemakers chi-squared step fitter.
//
// The reference's alternative step-fit algorithm (best fit vs counter-fit
// step-indicator S, stepfitting_library.py:342-505, with
// the _fit_steps/_best_split/_split_plateau machinery :113-339) is
// irreducibly sequential PER TRACE: each step splits the plateau whose
// best binary split minimizes total squared residuals, under forbidden-
// split constraints that depend on the evolving fit. It is embarrassingly
// parallel ACROSS traces, so this core runs the exact per-trace chain in
// C++ for a whole batch at once (threaded), replacing the per-trace
// Python loop (stepfitting.chi_squared_step_fitter is the oracle).
//
// Bit parity with the Python port (itself the exact reference port):
// - plateau heights are np.mean (numpy pairwise summation, same
//   blocked/unrolled order as stepchain.cpp);
// - squared-residual sums accumulate LEFT TO RIGHT like the reference's
//   builtin sum() (stepfitting_library.py:80) — near-tied split choices
//   under the <=-last-tie-wins rule depend on these exact doubles;
// - _split_plateau's running best starts at 2*big and updates on
//   total <= best (LAST tie wins); _best_split's cross-plateau best
//   starts at big = len*span^2 and updates on total < best (FIRST wins);
// - the counter-fit's forbidden splits replicate _best_split's rules:
//   best-fit boundary pairs, and the full interior of any best-fit
//   plateau containing a counter-fit plateau start (so each best-fit
//   plateau admits at most one counter-step) — note the initial
//   counter-fit plateau's start 0 forbids the first best-fit plateau's
//   interior immediately, a reference quirk preserved here;
// - S = counterfit_res / bestfit_res (1e10 when bestfit_res == 0);
//   the final pick is the max-S fit, first-in-order on ties (Python's
//   stable sorted(reverse=True)), or the longest fit when
//   ignore_counterfits is set.
//
// Efficiency (semantics-neutral): each plateau caches its best-split
// evaluation and is re-scanned only when it was just created or a new
// forbidden position landed inside its range — the evaluation is a pure
// function of (range, forbidden-in-range, trace), so caching cannot
// change results, only skip recomputation. Forbidden sets only grow
// within a run, and the best fit grows incrementally across the S loop
// exactly as the reference reuses existing_fit (:216-222).

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// ---- numpy pairwise summation (unit stride; same as stepchain.cpp) ----

double pairwise_sum(const double* a, int64_t n) {
    if (n < 8) {
        double res = 0.0;
        for (int64_t i = 0; i < n; i++) res += a[i];
        return res;
    } else if (n <= 128) {
        double r0 = a[0], r1 = a[1], r2 = a[2], r3 = a[3];
        double r4 = a[4], r5 = a[5], r6 = a[6], r7 = a[7];
        int64_t i;
        for (i = 8; i < n - (n % 8); i += 8) {
            r0 += a[i + 0]; r1 += a[i + 1]; r2 += a[i + 2]; r3 += a[i + 3];
            r4 += a[i + 4]; r5 += a[i + 5]; r6 += a[i + 6]; r7 += a[i + 7];
        }
        double res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7));
        for (; i < n; i++) res += a[i];
        return res;
    } else {
        int64_t n2 = n / 2;
        n2 -= n2 % 8;
        return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
    }
}

inline double np_mean(const double* a, int64_t n) {
    return pairwise_sum(a, n) / static_cast<double>(n);
}

// Sequential left-to-right residual sum — the reference's builtin
// sum([(lum - height)**2 ...]) op order (stepfitting_library.py:80).
inline double seq_res(const double* lum, int32_t start, int32_t stop,
                      double h) {
    double acc = 0.0;
    for (int32_t i = start; i <= stop; i++) {
        double d = lum[i] - h;
        acc += d * d;
    }
    return acc;
}

struct SplitEval {
    bool has;       // a permitted split exists (lp is not None)
    int32_t s;      // left = [start, s], right = [s+1, stop]
    double lh, rh;  // child heights (np_mean of the sub-ranges)
    double tot;     // left + right sequential residuals
};

struct Plat {
    int32_t start, stop;  // inclusive
    double height;
    bool dirty;
    SplitEval ev;
};

// Per-position split quantities for one range. These depend ONLY on
// (range, trace) — never on forbidden sets, min_step_length or
// min_step_magnitude — so each distinct range is evaluated once per
// trace and every later scan (counter-fits re-derive the same ranges
// across the whole S loop) replays the cached values under the current
// rules. Cannot change results: split_plateau's selection applies the
// rules positionally to identical doubles.
struct PosEval {
    double lm, rm;  // left/right heights (np_mean)
    double tot;     // left + right sequential residuals
};

struct RangeEntry {
    std::vector<PosEval> vals;   // stop-start entries, lazily filled
    std::vector<uint8_t> done;
};

struct RangeCache {
    // key = (start << 32) | stop.
    std::vector<std::pair<int64_t, RangeEntry>> entries;

    RangeEntry* find_or_add(int64_t key, int32_t n) {
        for (auto& e : entries)
            if (e.first == key) return &e.second;
        entries.emplace_back(key, RangeEntry());
        RangeEntry& re = entries.back().second;
        re.vals.resize(static_cast<size_t>(n));
        re.done.assign(static_cast<size_t>(n), 0);
        return &re;
    }
};

// Evaluate a sorted subset of split positions of one range: heights via
// np_mean, then the sequential residual sums with FOUR positions'
// accumulator chains interleaved — each chain keeps the reference's
// strict left-to-right order (masked lanes add +0.0, which is exact:
// squared terms are never -0.0), but the four independent chains hide
// the 4-cycle FP add latency that makes a lone sequential sum ~4x
// slower. Lazy per-position evaluation means positions a run's
// forbidden rules exclude (often whole best-fit plateau interiors) are
// never computed at all.
void eval_positions(const double* lum, int32_t start, int32_t stop,
                    const int32_t* pos, int32_t np, RangeEntry& re) {
    for (int32_t q = 0; q < np; q++) {
        const int32_t s = pos[q];
        re.vals[s - start].lm = np_mean(lum + start, s - start + 1);
        re.vals[s - start].rm = np_mean(lum + s + 1, stop - s);
        re.done[s - start] = 1;
    }
    for (int32_t g = 0; g < np; g += 4) {
        const int32_t k = std::min<int32_t>(4, np - g);
        double accl[4] = {0.0, 0.0, 0.0, 0.0};
        double accr[4] = {0.0, 0.0, 0.0, 0.0};
        int32_t send[4];
        double hl[4], hr[4];
        for (int32_t j = 0; j < k; j++) {
            send[j] = pos[g + j];
            hl[j] = re.vals[send[j] - start].lm;
            hr[j] = re.vals[send[j] - start].rm;
        }
        for (int32_t j = k; j < 4; j++) {
            send[j] = send[k - 1];
            hl[j] = hr[j] = 0.0;
        }
        // left residuals: [start, s_j]
        for (int32_t i = start; i <= send[3]; i++) {
            const double v = lum[i];
            for (int32_t j = 0; j < 4; j++) {
                const double d = v - hl[j];
                accl[j] += (i <= send[j]) ? d * d : 0.0;
            }
        }
        // right residuals: [s_j + 1, stop]
        for (int32_t i = send[0] + 1; i <= stop; i++) {
            const double v = lum[i];
            for (int32_t j = 0; j < 4; j++) {
                const double d = v - hr[j];
                accr[j] += (i > send[j]) ? d * d : 0.0;
            }
        }
        for (int32_t j = 0; j < k; j++)
            re.vals[send[j] - start].tot = accl[j] + accr[j];
    }
}

struct TraceCtx {
    const double* lum;
    int32_t T;
    double big;          // len * span^2  (_best_split's initial best)
    double big2;         // 2 * big       (_split_plateau's initial best)
    double msm;          // min_step_magnitude
    int32_t msl;         // min_step_length (2 best fit, 0 counter fit)
    const uint8_t* forbid;  // per-position forbidden splits (or null)
    RangeCache* cache;
};

// _split_plateau (stepfitting_library.py:113-179): best binary split of
// one plateau; <= keeps the LAST tie like the reference. Per-position
// quantities come from the range cache; only the rule filters and the
// running-best replay happen per call.
SplitEval split_plateau(const TraceCtx& c, int32_t start, int32_t stop) {
    SplitEval ev;
    ev.has = false;
    ev.s = -1;
    ev.lh = ev.rh = 0.0;
    ev.tot = c.big2;
    if (start >= stop) return ev;
    const bool short_plateau = (stop - start < c.msl);
    if (short_plateau) return ev;
    const int64_t key = (static_cast<int64_t>(start) << 32) |
        static_cast<uint32_t>(stop);
    RangeEntry* re = nullptr;
    int32_t need[4];
    int32_t nn = 0;
    for (int32_t s = start; s < stop; s++) {
        if (c.msl > 0 && (s - start < c.msl || stop - s < c.msl)) continue;
        if (c.forbid && c.forbid[s]) continue;
        if (!re) re = c.cache->find_or_add(key, stop - start);
        if (!re->done[s - start]) {
            need[nn++] = s;
            if (nn == 4) {
                eval_positions(c.lum, start, stop, need, nn, *re);
                nn = 0;
            }
        }
    }
    if (nn) eval_positions(c.lum, start, stop, need, nn, *re);
    if (!re) return ev;  // every position filtered before evaluation
    for (int32_t s = start; s < stop; s++) {
        if (c.msl > 0 && (s - start < c.msl || stop - s < c.msl)) continue;
        if (c.forbid && c.forbid[s]) continue;
        const PosEval& q = re->vals[s - start];
        if (std::fabs(q.lm - q.rm) < c.msm) continue;
        if (q.tot <= ev.tot) {
            ev.has = true;
            ev.s = s;
            ev.lh = q.lm;
            ev.rh = q.rm;
            ev.tot = q.tot;
        }
    }
    return ev;
}

// _best_split's cross-plateau selection (stepfitting_library.py:182-271):
// strict <, FIRST plateau wins ties. Returns the plateau index or -1.
int best_split_replay(std::vector<Plat>& pl, const TraceCtx& c) {
    double best_res = c.big;
    int best_i = -1;
    for (size_t i = 0; i < pl.size(); i++) {
        if (pl[i].dirty) {
            pl[i].ev = split_plateau(c, pl[i].start, pl[i].stop);
            pl[i].dirty = false;
        }
        const SplitEval& ev = pl[i].ev;
        if (ev.has && ev.tot < best_res) {
            best_res = ev.tot;
            best_i = static_cast<int>(i);
        }
    }
    return best_i;
}

void apply_split(std::vector<Plat>& pl, int i) {
    const SplitEval ev = pl[i].ev;
    Plat left{pl[i].start, ev.s, ev.lh, true, {}};
    Plat right{static_cast<int32_t>(ev.s + 1), pl[i].stop, ev.rh, true, {}};
    pl[i] = left;
    pl.insert(pl.begin() + i + 1, right);
}

// sum(_plateau_squared_residuals(...) for p in plateaus): sequential
// left-to-right over plateaus, each itself sequential.
double plateaus_seq_residuals(const double* lum, const std::vector<Plat>& pl) {
    double acc = 0.0;
    for (const Plat& p : pl) acc += seq_res(lum, p.start, p.stop, p.height);
    return acc;
}

// Counter fit: _fit_steps(lum, target, bestfit_plateaus=best_fit,
// existing_fit=None, min_step_length=0) with _best_split's forbidden
// rules (stepfitting_library.py:182-271).
std::vector<Plat> counterfit(const TraceCtx& base, const std::vector<Plat>& bf,
                             int32_t target, std::vector<uint8_t>& forbid,
                             std::vector<int32_t>& bf_index,
                             std::vector<uint8_t>& bf_hit) {
    const int32_t T = base.T;
    std::fill(forbid.begin(), forbid.end(), 0);
    // Static part: best-fit boundary pairs (stop, next_start) — only a
    // contiguous boundary (next_start == stop + 1) can ever match the
    // (s, s+1) membership test.
    for (size_t j = 0; j + 1 < bf.size(); j++)
        if (bf[j + 1].start == bf[j].stop + 1) forbid[bf[j].stop] = 1;
    for (size_t j = 0; j < bf.size(); j++)
        for (int32_t f = bf[j].start; f <= bf[j].stop; f++)
            bf_index[f] = static_cast<int32_t>(j);
    std::fill(bf_hit.begin(), bf_hit.begin() + bf.size(), 0);

    std::vector<Plat> cf;
    cf.push_back({0, static_cast<int32_t>(T - 1), np_mean(base.lum, T),
                  true, {}});
    TraceCtx c = base;
    c.msl = 0;
    c.forbid = forbid.data();

    // A counter-fit plateau start inside best-fit plateau j forbids ALL
    // of j's interior splits. Monotone: once hit, always hit.
    auto add_start = [&](int32_t f) {
        int32_t j = bf_index[f];
        if (bf_hit[j]) return;
        bf_hit[j] = 1;
        bool added = false;
        for (int32_t u = bf[j].start; u < bf[j].stop; u++) {
            if (!forbid[u]) {
                forbid[u] = 1;
                added = true;
            }
        }
        if (added) {
            for (Plat& p : cf)
                if (p.start <= bf[j].stop && p.stop >= bf[j].start)
                    p.dirty = true;
        }
    };
    add_start(0);
    while (static_cast<int32_t>(cf.size()) < target) {
        int i = best_split_replay(cf, c);
        if (i < 0) break;
        int32_t new_start = cf[i].ev.s + 1;
        apply_split(cf, i);
        add_start(new_start);
    }
    return cf;
}

void run_chisq_trace(const double* lum, int32_t T, int32_t num_plateaus,
                     int32_t msl, double msm, int32_t ignore_cf,
                     int32_t* out_n, int32_t* out_start, int32_t* out_stop,
                     double* out_height) {
    double mx = lum[0], mn = lum[0];
    for (int32_t i = 1; i < T; i++) {
        if (lum[i] > mx) mx = lum[i];
        if (lum[i] < mn) mn = lum[i];
    }
    double span = mx - mn;
    double big = static_cast<double>(T) * (span * span);
    RangeCache cache;
    TraceCtx cb{lum, T, big, 2.0 * big, msm, msl, nullptr, &cache};

    std::vector<Plat> best;
    best.push_back({0, static_cast<int32_t>(T - 1), np_mean(lum, T),
                    true, {}});
    struct Fit {
        std::vector<Plat> pl;
        double S;
    };
    std::vector<Fit> fits;
    std::vector<uint8_t> forbid(static_cast<size_t>(T));
    std::vector<int32_t> bf_index(static_cast<size_t>(T));
    std::vector<uint8_t> bf_hit(static_cast<size_t>(T));

    for (int32_t p = 1; p <= num_plateaus; p++) {
        while (static_cast<int32_t>(best.size()) < p) {
            int i = best_split_replay(best, cb);
            if (i < 0) break;
            apply_split(best, i);
        }
        if (!fits.empty() && best.size() == fits.back().pl.size()) break;
        if (p + 1 > T) {
            // Host parity: _fit_steps(seq, p + 1) raises ValueError when
            // p + 1 > T (the reference's stepfitting_library.py:277-280;
            // reachable with num_steps = T - 1 and min_step_length = 0).
            // Flag the trace; the Python wrapper raises identically.
            *out_n = -1;
            return;
        }
        double bf_res = plateaus_seq_residuals(lum, best);
        std::vector<Plat> cf = counterfit(cb, best, p + 1, forbid,
                                          bf_index, bf_hit);
        double cf_res = plateaus_seq_residuals(lum, cf);
        double S = (bf_res != 0.0) ? (cf_res / bf_res) : 1e10;
        fits.push_back({best, S});
    }
    size_t pick = 0;
    if (ignore_cf) {
        for (size_t i = 1; i < fits.size(); i++)
            if (fits[i].pl.size() > fits[pick].pl.size()) pick = i;
    } else {
        for (size_t i = 1; i < fits.size(); i++)
            if (fits[i].S > fits[pick].S) pick = i;
    }
    const std::vector<Plat>& out = fits[pick].pl;
    *out_n = static_cast<int32_t>(out.size());
    for (size_t i = 0; i < out.size(); i++) {
        out_start[i] = out[i].start;
        out_stop[i] = out[i].stop;
        out_height[i] = out[i].height;
    }
}

}  // namespace

extern "C" int cs_chisq_batch(const double* traces, int32_t N, int32_t T,
                              int32_t num_plateaus, int32_t min_step_length,
                              double min_step_magnitude,
                              int32_t ignore_counterfits, int32_t n_threads,
                              int32_t* out_n, int32_t* out_start,
                              int32_t* out_stop, double* out_height) {
    if (N <= 0) return 0;
    if (T < 2 || num_plateaus < 1 || num_plateaus > T) return 1;
    auto work = [&](int32_t lo, int32_t hi) {
        for (int32_t i = lo; i < hi; i++) {
            int64_t off = static_cast<int64_t>(i) * T;
            run_chisq_trace(traces + off, T, num_plateaus, min_step_length,
                            min_step_magnitude, ignore_counterfits,
                            out_n + i, out_start + off, out_stop + off,
                            out_height + off);
        }
    };
    int32_t nt = n_threads;
    if (nt <= 1 || N < 8) {
        work(0, N);
        return 0;
    }
    nt = std::min<int32_t>(nt, N);
    std::vector<std::thread> threads;
    int32_t chunk = (N + nt - 1) / nt;
    for (int32_t k = 0; k < nt; k++) {
        int32_t lo = k * chunk;
        int32_t hi = std::min(lo + chunk, N);
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& t : threads) t.join();
    return 0;
}
