// Native step-fit post-pass: plateau assembly from sliding-t masks,
// refit on the raw trace, and the iterated drop-sort Welch-t merge
// filter. Semantics mirror stepfitting.py's host chain (itself the
// exact port of the reference's stepfitting_library.py:1328-1480):
// the device (ops/stepfit_batch.py) produces the Chung-Kennedy filter
// and step masks in one dispatch; this core replaces the per-trace
// Python loop that dominated batched step fitting (~2.6 ms/trace of
// numpy-slice Welch tests).
//
// Numerics:
// - means replicate numpy's pairwise summation (8-accumulator blocks,
//   128-element leaves) so plateau heights are bit-equal to np.mean;
// - Welch t / df follow scipy.stats.ttest_ind(equal_var=False)'s
//   float-op order exactly (see stepfitting._welch_t);
// - the Student-t sf uses the regularized incomplete beta via the
//   classic Moshier power-series / continued-fraction method; for the
//   non-integer Welch-Satterthwaite df this agrees with
//   scipy.special.stdtr to ~1e-12 relative, far inside the margin of
//   the p>=threshold merge gate and the drop-sort ordering on noisy
//   traces (validated against the host chain in
//   tests/test_stepfit_batch.py / test_native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr double MACHEP = 1.11022302462515654042e-16;
constexpr double MAXLOG = 7.09782712893383996732e2;
constexpr double MINLOG = -7.451332191019412076235e2;
constexpr double MAXGAM = 171.624376956302725;
constexpr double BIG = 4.503599627370496e15;
constexpr double BIGINV = 2.22044604925031308085e-16;

// ---- numpy pairwise summation (unit stride) ----------------------------

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

// ---- regularized incomplete beta (Moshier's method) ---------------------

double incbcf(double a, double b, double x) {
    double k1 = a, k2 = a + b, k3 = a, k4 = a + 1.0;
    double k5 = 1.0, k6 = b - 1.0, k7 = k4, k8 = a + 2.0;
    double pkm2 = 0.0, qkm2 = 1.0, pkm1 = 1.0, qkm1 = 1.0;
    double ans = 1.0, r = 1.0, t;
    double thresh = 3.0 * MACHEP;
    int n = 0;
    do {
        double xk = -(x * k1 * k2) / (k3 * k4);
        double pk = pkm1 + pkm2 * xk;
        double qk = qkm1 + qkm2 * xk;
        pkm2 = pkm1; pkm1 = pk; qkm2 = qkm1; qkm1 = qk;

        xk = (x * k5 * k6) / (k7 * k8);
        pk = pkm1 + pkm2 * xk;
        qk = qkm1 + qkm2 * xk;
        pkm2 = pkm1; pkm1 = pk; qkm2 = qkm1; qkm1 = qk;

        if (qk != 0) r = pk / qk;
        if (r != 0) { t = std::fabs((ans - r) / r); ans = r; }
        else t = 1.0;
        if (t < thresh) break;

        k1 += 1.0; k2 += 1.0; k3 += 2.0; k4 += 2.0;
        k5 += 1.0; k6 -= 1.0; k7 += 2.0; k8 += 2.0;

        if (std::fabs(qk) + std::fabs(pk) > BIG) {
            pkm2 *= BIGINV; pkm1 *= BIGINV; qkm2 *= BIGINV; qkm1 *= BIGINV;
        }
        if (std::fabs(qk) < BIGINV || std::fabs(pk) < BIGINV) {
            pkm2 *= BIG; pkm1 *= BIG; qkm2 *= BIG; qkm1 *= BIG;
        }
    } while (++n < 300);
    return ans;
}

double incbd(double a, double b, double x) {
    double k1 = a, k2 = b - 1.0, k3 = a, k4 = a + 1.0;
    double k5 = 1.0, k6 = a + b, k7 = a + 1.0, k8 = a + 2.0;
    double pkm2 = 0.0, qkm2 = 1.0, pkm1 = 1.0, qkm1 = 1.0;
    double ans = 1.0, r = 1.0, t;
    double z = x / (1.0 - x);
    double thresh = 3.0 * MACHEP;
    int n = 0;
    do {
        double xk = -(z * k1 * k2) / (k3 * k4);
        double pk = pkm1 + pkm2 * xk;
        double qk = qkm1 + qkm2 * xk;
        pkm2 = pkm1; pkm1 = pk; qkm2 = qkm1; qkm1 = qk;

        xk = (z * k5 * k6) / (k7 * k8);
        pk = pkm1 + pkm2 * xk;
        qk = qkm1 + qkm2 * xk;
        pkm2 = pkm1; pkm1 = pk; qkm2 = qkm1; qkm1 = qk;

        if (qk != 0) r = pk / qk;
        if (r != 0) { t = std::fabs((ans - r) / r); ans = r; }
        else t = 1.0;
        if (t < thresh) break;

        k1 += 1.0; k2 -= 1.0; k3 += 2.0; k4 += 2.0;
        k5 += 1.0; k6 += 1.0; k7 += 2.0; k8 += 2.0;

        if (std::fabs(qk) + std::fabs(pk) > BIG) {
            pkm2 *= BIGINV; pkm1 *= BIGINV; qkm2 *= BIGINV; qkm1 *= BIGINV;
        }
        if (std::fabs(qk) < BIGINV || std::fabs(pk) < BIGINV) {
            pkm2 *= BIG; pkm1 *= BIG; qkm2 *= BIG; qkm1 *= BIG;
        }
    } while (++n < 300);
    return ans;
}

double pseries(double a, double b, double x) {
    double ai = 1.0 / a;
    double u = (1.0 - b) * x;
    double v = u / (a + 1.0);
    double t1 = v;
    double t = u;
    double n = 2.0;
    double s = 0.0;
    double z = MACHEP * ai;
    while (std::fabs(v) > z) {
        u = (n - b) * x / n;
        t *= u;
        v = t / (a + n);
        s += v;
        n += 1.0;
    }
    s += t1;
    s += ai;

    u = a * std::log(x);
    if ((a + b) < MAXGAM && std::fabs(u) < MAXLOG) {
        t = std::tgamma(a + b) / (std::tgamma(a) * std::tgamma(b));
        s = s * t * std::pow(x, a);
    } else {
        t = std::lgamma(a + b) - std::lgamma(a) - std::lgamma(b) +
            u + std::log(s);
        if (t < MINLOG) s = 0.0;
        else s = std::exp(t);
    }
    return s;
}

double incbet(double aa, double bb, double xx) {
    if (aa <= 0.0 || bb <= 0.0) return NAN;
    if (xx <= 0.0) return xx == 0.0 ? 0.0 : NAN;
    if (xx >= 1.0) return xx == 1.0 ? 1.0 : NAN;

    int flag = 0;
    double a, b, x, xc;
    if (bb * xx <= 1.0 && xx <= 0.95)
        return pseries(aa, bb, xx);
    double w = 1.0 - xx;

    if (xx > aa / (aa + bb)) {
        flag = 1;
        a = bb; b = aa; xc = xx; x = w;
    } else {
        a = aa; b = bb; xc = w; x = xx;
    }

    double t;
    if (flag == 1 && (b * x) <= 1.0 && x <= 0.95) {
        t = pseries(a, b, x);
    } else {
        double y = x * (a + b - 2.0) - (a - 1.0);
        if (y < 0.0)
            w = incbcf(a, b, x);
        else
            w = incbd(a, b, x) / xc;

        y = a * std::log(x);
        t = b * std::log(xc);
        if ((a + b) < MAXGAM && std::fabs(y) < MAXLOG &&
            std::fabs(t) < MAXLOG) {
            t = std::pow(xc, b);
            t *= std::pow(x, a);
            t /= a;
            t *= w;
            t *= std::tgamma(a + b) / (std::tgamma(a) * std::tgamma(b));
        } else {
            y += t + std::lgamma(a + b) - std::lgamma(a) - std::lgamma(b);
            y += std::log(w / a);
            if (y < MINLOG) t = 0.0;
            else t = std::exp(y);
        }
    }
    if (flag == 1) {
        if (t <= MACHEP) t = 1.0 - MACHEP;
        else t = 1.0 - t;
    }
    return t;
}

// Two-tailed Welch p: 2 * stdtr(df, -|t|) with the incbet identity
// (exact for t < 0; Welch df is non-integer so scipy takes the same
// incbet path to ~1e-12).
// scratch must hold max(n1, n2) doubles — callers in the per-trace
// merge loop reuse one buffer so the hot path never touches the
// allocator (the per-call std::vector serialized worker threads).
double welch_p(const double* a, int64_t n1, const double* b, int64_t n2,
               double* scratch) {
    if (n1 == 0 || n2 == 0) return NAN;
    double m1 = np_mean(a, n1);
    double m2 = np_mean(b, n2);
    // scipy's _var: second central moment * n/(n-1) (same op order).
    double* d = scratch;
    for (int64_t i = 0; i < n1; i++) {
        double dd = a[i] - m1;
        d[i] = dd * dd;
    }
    double v1 = np_mean(d, n1) *
        (static_cast<double>(n1) / static_cast<double>(n1 - 1));
    for (int64_t i = 0; i < n2; i++) {
        double dd = b[i] - m2;
        d[i] = dd * dd;
    }
    double v2 = np_mean(d, n2) *
        (static_cast<double>(n2) / static_cast<double>(n2 - 1));
    double vn1 = v1 / static_cast<double>(n1);
    double vn2 = v2 / static_cast<double>(n2);
    double df = (vn1 + vn2) * (vn1 + vn2) /
        (vn1 * vn1 / static_cast<double>(n1 - 1) +
         vn2 * vn2 / static_cast<double>(n2 - 1));
    if (std::isnan(df)) df = 1.0;
    double t = (m1 - m2) / std::sqrt(vn1 + vn2);
    if (std::isnan(t)) return NAN;
    double at = std::fabs(t);
    if (at == 0.0) return 1.0;  // 2 * stdtr(df, 0) = 2 * 0.5
    if (std::isinf(at)) return 0.0;
    double z = df / (df + at * at);
    return incbet(0.5 * df, 0.5, z);  // == 2 * (0.5 * incbet(...))
}

// ---- plateau machinery --------------------------------------------------

struct Plateau {
    int32_t start;
    int32_t stop;   // inclusive
    double height;
};

inline Plateau fit_plateau(const double* raw, int32_t start, int32_t stop) {
    return {start, stop, np_mean(raw + start, stop - start + 1)};
}

// One drop-sort merge pass (stepfitting._t_test_filter_singlepass).
// Returns true if anything merged.
bool tfilter_singlepass(const double* raw, std::vector<Plateau>& pl,
                        double p_threshold, int32_t no_merge_start,
                        double* scratch) {
    size_t m = pl.size();
    if (m < 2) return false;
    size_t npairs = m - 1;
    std::vector<double> pvals(npairs);
    for (size_t r = 0; r < npairs; r++) {
        const Plateau& a = pl[r];
        const Plateau& b = pl[r + 1];
        pvals[r] = welch_p(raw + a.start, a.stop - a.start + 1,
                           raw + b.start, b.stop - b.start + 1, scratch);
    }
    // Stable descending p, ties by ascending pair index; NaN p-values
    // (zero-variance equal-mean pairs) deterministically LAST — the
    // same -inf key the Python chain uses (stepfitting.py
    // _t_test_filter_singlepass), since CPython sorted() with NaN keys
    // is implementation-defined.
    std::vector<int32_t> order(npairs);
    for (size_t i = 0; i < npairs; i++) order[i] = static_cast<int32_t>(i);
    std::stable_sort(order.begin(), order.end(),
                     [&](int32_t x, int32_t y) {
                         double px = pvals[x], py = pvals[y];
                         if (std::isnan(px)) return false;
                         if (std::isnan(py)) return true;
                         return px > py;
                     });
    std::vector<uint8_t> merge_by_rank(npairs, 0);
    std::vector<int32_t> accepted;
    for (size_t i = 0; i < npairs; i++) {
        int32_t r = order[i];
        double p = pvals[r];
        bool ok = !std::isnan(p) && p >= p_threshold &&
            pl[r].stop >= no_merge_start;
        if (!ok) continue;
        // veto if an earlier-accepted merge shares a plateau
        bool vetoed = false;
        for (int32_t r2 : accepted) {
            if (r2 == r - 1 || r2 == r + 1) { vetoed = true; break; }
        }
        if (!vetoed) {
            accepted.push_back(r);
            merge_by_rank[r] = 1;
        }
    }
    // apply (original pair order, skipping consumed plateaus)
    std::vector<Plateau> filtered;
    filtered.reserve(m);
    bool changed = false;
    for (size_t r = 0; r < npairs; r++) {
        const Plateau& a = pl[r];
        const Plateau& b = pl[r + 1];
        if (!filtered.empty() && a.stop == filtered.back().stop) continue;
        if (merge_by_rank[r]) {
            filtered.push_back(fit_plateau(raw, a.start, b.stop));
            changed = true;
        } else {
            filtered.push_back(a);
        }
    }
    if (pl.back().stop != filtered.back().stop)
        filtered.push_back(pl.back());
    pl.swap(filtered);
    return changed;
}

void run_trace(const double* raw, const uint8_t* mask, int32_t Tm,
               double p_threshold, int32_t no_merge_start,
               int32_t* refit_n, int32_t* refit_start, int32_t* refit_stop,
               double* refit_height, int32_t* tfil_n, int32_t* tfil_start,
               int32_t* tfil_stop, double* tfil_height) {
    // step positions: last index of each consecutive run of mask hits
    // One scratch buffer per trace: every Welch segment is <= Tm long,
    // so the merge loop below never touches the allocator.
    std::vector<double> scratch(static_cast<size_t>(Tm));
    std::vector<int32_t> steps;
    int32_t prev = -2;
    for (int32_t f = 0; f < Tm; f++) {
        if (!mask[f]) continue;
        if (f == prev + 1) steps.back() = f;
        else steps.push_back(f);
        prev = f;
    }
    std::vector<Plateau> pl;
    if (steps.empty()) {
        pl.push_back(fit_plateau(raw, 0, Tm - 1));
    } else {
        pl.push_back(fit_plateau(raw, 0, steps[0] - 1));
        for (size_t i = 0; i + 1 < steps.size(); i++)
            pl.push_back(fit_plateau(raw, steps[i], steps[i + 1] - 1));
        pl.push_back(fit_plateau(raw, steps.back(), Tm - 1));
    }
    *refit_n = static_cast<int32_t>(pl.size());
    for (size_t i = 0; i < pl.size(); i++) {
        refit_start[i] = pl[i].start;
        refit_stop[i] = pl[i].stop;
        refit_height[i] = pl[i].height;
    }
    // t_test_filter: len(initial)-1 passes; a pass with no merge leaves
    // the list unchanged, so later passes are no-ops — break early.
    size_t passes = pl.size() - 1;
    std::vector<Plateau> cur = pl;
    for (size_t k = 0; k < passes; k++) {
        if (!tfilter_singlepass(raw, cur, p_threshold, no_merge_start,
                                scratch.data()))
            break;
    }
    *tfil_n = static_cast<int32_t>(cur.size());
    for (size_t i = 0; i < cur.size(); i++) {
        tfil_start[i] = cur[i].start;
        tfil_stop[i] = cur[i].stop;
        tfil_height[i] = cur[i].height;
    }
}

}  // namespace

extern "C" int sc_postpass(const double* raw, const uint8_t* mask,
                           int32_t N, int32_t Tm, double p_threshold,
                           int32_t no_merge_start, int32_t n_threads,
                           int32_t* refit_n, int32_t* refit_start,
                           int32_t* refit_stop, double* refit_height,
                           int32_t* tfil_n, int32_t* tfil_start,
                           int32_t* tfil_stop, double* tfil_height) {
    if (N <= 0) return 0;
    if (Tm < 1) return 1;
    // A step AT frame 0 would make a plateau that ends before it starts
    // (the Python chain raises ValueError); rejecting it up front also
    // bounds the per-trace plateau count at Tm, the output buffer width.
    for (int32_t i = 0; i < N; i++) {
        if (mask[static_cast<int64_t>(i) * Tm]) return 2;
    }
    auto work = [&](int32_t lo, int32_t hi) {
        for (int32_t i = lo; i < hi; i++) {
            int64_t off = static_cast<int64_t>(i) * Tm;
            run_trace(raw + off, mask + off, Tm, p_threshold,
                      no_merge_start, refit_n + i, refit_start + off,
                      refit_stop + off, refit_height + off, tfil_n + i,
                      tfil_start + off, tfil_stop + off, tfil_height + off);
        }
    };
    int32_t nt = n_threads;
    if (nt <= 1 || N < 64) {
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

// Standalone Welch p over arrays (for differential tests).
extern "C" void sc_welch_p_batch(const double* a, const int32_t* a_off,
                                 const int32_t* a_len, const double* b,
                                 const int32_t* b_off, const int32_t* b_len,
                                 int32_t n, double* out) {
    int32_t mx = 1;
    for (int32_t i = 0; i < n; i++)
        mx = std::max(mx, std::max(a_len[i], b_len[i]));
    std::vector<double> scratch(static_cast<size_t>(mx));
    for (int32_t i = 0; i < n; i++)
        out[i] = welch_p(a + a_off[i], a_len[i], b + b_off[i], b_len[i],
                         scratch.data());
}
