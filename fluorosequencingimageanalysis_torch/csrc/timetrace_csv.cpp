// Native writer of the timetrace CSV: the rows that
// pipeline/experiment.py::TimetraceExperiment.save_experiment_as_csv
// writes for run_timetrace's results (flexlibrary.py:3550-3709), laid out
// byte for byte from the step-fit arrays instead of from per-row Python
// objects, threaded over the traces.
//
// One row per trace and frame, in the excel dialect (',' between cells,
// "\r\n" after each row; no cell the writer makes needs quoting):
//   Trace #, Hcoord, Wcoord, Frame #, Photometry
//   [Step #, Plateau Height, Step Size, Plateau Length, Overall Fit R^2]
//   [the intermediates, in the order the header gives them]
// with the class method's held-value rules: the step-fit cells are
// recomputed only at the start of a t-filtered plateau (last_step_info
// and frame_plateau on the t-filtered plateaus), each plateau
// intermediate is held from the start of one of its plateaus (None until
// the first), and the photometry intermediates change every frame.
//
// Numbers are laid out as Python writes them:
// - a float as repr(float) (pyrepr.h);
// - an integer in decimal, and a missing step as "None".
// The fit's R^2 is Trace.coefficient_of_determination's bit for bit:
// x ** 2 as CPython's float power computes it (libm's pow), the sums as
// CPython's sum() (Neumaier-compensated from 3.12 on, chosen by the
// caller), the mean as numpy's pairwise sum over the row.

#include <algorithm>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <unistd.h>

#include "pyrepr.h"

namespace {

// Error codes, in the Python exception each stands for; the trace and
// frame at fault go back beside the code.
enum Err : int64_t {
    OK = 0,
    NO_PLATEAU_TYPE_ERROR = 1,     // frame_plateau found none: None - None
    FRAME_COUNT_EXCEPTION = 2,     // trace_comparison_rss: lengths differ
    T_FILTERED_VALUE_ERROR = 3,    // plateau_value outside the t-filtered
    REFIT_VALUE_ERROR = 4,         // plateau_value outside the refit
    ZERO_DIVISION_ERROR = 5,       // tss == 0
    OVERFLOW_ERROR = 6,            // float ** 2 out of range
};

// The intermediate columns, by the code the binding passes.
enum Column : int32_t { CK = 0, PHOTOMETRIES = 1, REFIT = 2, T_FILTERED = 3 };

// CPython's float ** 2 ends in the platform's pow(x, 2.0), which differs
// from x * x in the last bit on some inputs; g++ folds a visible
// pow(x, 2.0) into x * x, so the call goes through a pointer it cannot
// see through.
double (*volatile libm_pow)(double, double) =
    static_cast<double (*)(double, double)>(&::pow);

// float_pow(x, 2.0) as CPython computes it: special values first, then
// pow(|x|, 2.0); a finite x whose square overflows raises OverflowError.
bool py_square(double x, double* out) {
    if (std::isnan(x) || std::isinf(x)) {
        *out = std::fabs(x);
        return true;
    }
    double ax = std::fabs(x);
    if (ax == 0.0 || ax == 1.0) {
        *out = ax;
        return true;
    }
    double r = libm_pow(ax, 2.0);
    if (std::isinf(r)) return false;
    *out = r;
    return true;
}

// CPython's sum() over floats from the int start 0: the first item is
// 0 + x, then each item is added plainly (before 3.12) or with Neumaier's
// compensation (3.12 on), which is added back at the end when it is
// nonzero and finite.
struct PySum {
    bool neumaier;
    bool started = false;
    double f = 0.0;
    double c = 0.0;
    explicit PySum(bool n) : neumaier(n) {}
    void add(double x) {
        if (!started) {
            f = 0.0 + x;
            started = true;
            return;
        }
        if (!neumaier) {
            f += x;
            return;
        }
        double t = f + x;
        if (std::fabs(f) >= std::fabs(x)) {
            c += (f - t) + x;
        } else {
            c += (x - t) + f;
        }
        f = t;
    }
    double value() const {
        if (neumaier && c != 0.0 && std::isfinite(c)) return f + c;
        return f;
    }
};

// numpy's pairwise summation of a contiguous float64 row (8 accumulators
// up to 128 elements, halves above), as in csrc/stepchain.cpp.
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
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// np.mean of a float64 row: the reduction starts from add's identity 0.0
// (so a row of -0.0 means 0.0), then divides by the count.
double np_mean(const double* a, int64_t n) {
    return (0.0 + pairwise_sum(a, n)) / static_cast<double>(n);
}

// One trace's plateaus (start, stop, height), unmirrored.
struct Plateaus {
    const int32_t* start;
    const int32_t* stop;
    const double* height;
    int32_t n;

    // stepfitting.plateau_value / frame_plateau: the first plateau
    // holding the frame, or -1.
    int32_t at(int64_t f) const {
        for (int32_t k = 0; k < n; k++) {
            if (start[k] <= f && f <= stop[k]) return k;
        }
        return -1;
    }

    // stepfitting.last_step_info(plateaus, f) as the class method calls
    // it, a plateau read as (pre, post, magnitude): the step's index, or
    // -1 for (None, None, None).
    int32_t last_step(int64_t f) const {
        for (int32_t s = 0; s + 1 < n; s++) {
            if (stop[s] <= f && f <= start[s + 1]) return s;
        }
        if (n == 0) return -1;
        if (f >= start[n - 1]) return n - 1;
        return -1;
    }
};

struct Inputs {
    int64_t N, T;
    const int64_t* h0;
    const int64_t* w0;
    const double* phot;
    const double* ck;
    const int32_t *rf_n, *rf_s, *rf_e;
    const double* rf_h;
    int64_t rf_w;
    const int32_t *tf_n, *tf_s, *tf_e;
    const double* tf_h;
    int64_t tf_w;
    bool step_fits;
    const int32_t* columns;
    int32_t n_columns;
    bool neumaier;

    Plateaus refit(int64_t i) const {
        return {rf_s + i * rf_w, rf_e + i * rf_w, rf_h + i * rf_w, rf_n[i]};
    }
    Plateaus t_filtered(int64_t i) const {
        return {tf_s + i * tf_w, tf_e + i * tf_w, tf_h + i * tf_w, tf_n[i]};
    }
};

struct Fault {
    int64_t code = OK, trace = -1, frame = -1;
};

// Trace.coefficient_of_determination(photometries, t-filtered fit).
int64_t r_squared(const double* phot, int64_t T, const Plateaus& tf,
                  bool neumaier, double* r2, int64_t* frame) {
    int64_t fit_frames = tf.n > 0 ? int64_t{tf.stop[tf.n - 1]} + 1 : 0;
    if (fit_frames != T) return FRAME_COUNT_EXCEPTION;
    PySum rss(neumaier);
    for (int64_t f = 0; f < T; f++) {
        int32_t k = tf.at(f);
        if (k < 0) {
            *frame = f;
            return T_FILTERED_VALUE_ERROR;
        }
        double sq;
        if (!py_square(phot[f] - tf.height[k], &sq)) return OVERFLOW_ERROR;
        rss.add(sq);
    }
    double m = np_mean(phot, T);
    PySum tss(neumaier);
    for (int64_t f = 0; f < T; f++) {
        double sq;
        if (!py_square(phot[f] - m, &sq)) return OVERFLOW_ERROR;
        tss.add(sq);
    }
    double t = tss.value();
    if (t == 0.0) return ZERO_DIVISION_ERROR;
    *r2 = 1.0 - rss.value() / t;
    return OK;
}

// Appends to a growing text buffer.
struct Text {
    std::string s;
    void put(const char* p, size_t n) { s.append(p, n); }
    void put(const std::string& t) { s.append(t); }
    void put_int(int64_t v) {
        char b[24];
        put(b, std::to_chars(b, b + sizeof b, v).ptr - b);
    }
    void put_double(double v) {
        char b[32];
        put(b, pyrepr::put_double(b, v) - b);
    }
};

// The reprs of a row of doubles, held end to end with their offsets.
struct Reprs {
    std::string text;
    std::vector<uint32_t> off;
    void fill(const double* v, int64_t n) {
        text.clear();
        off.assign(1, 0);
        char b[32];
        for (int64_t i = 0; i < n; i++) {
            text.append(b, pyrepr::put_double(b, v[i]) - b);
            off.push_back(static_cast<uint32_t>(text.size()));
        }
    }
    void put(Text& out, int64_t i) const {
        out.put(text.data() + off[i], off[i + 1] - off[i]);
    }
    std::string str(int64_t i) const {
        return text.substr(off[i], off[i + 1] - off[i]);
    }
};

// Formats traces [lo, hi) into out; stops at the first trace at fault,
// whose rows the caller then discards with the rest of the round.
void format_block(const Inputs& in, int64_t lo, int64_t hi, Text& out,
                  Fault& fault) {
    const int64_t T = in.T;
    bool has[4] = {false, false, false, false};
    for (int32_t c = 0; c < in.n_columns; c++) has[in.columns[c]] = true;
    const bool need_tf = in.step_fits || has[T_FILTERED];
    Reprs phot_r, ck_r, rf_r, tf_r;
    std::vector<uint8_t> tf_start(T), rf_start(T);
    std::string held[4], step_cells, prefix;
    bool held_set[4];
    out.s.reserve(static_cast<size_t>((hi - lo) * T) *
                  (40 + 26 * (in.n_columns + (in.step_fits ? 5 : 0))));
    for (int64_t i = lo; i < hi; i++) {
        const double* phot = in.phot + i * T;
        const Plateaus tf = in.t_filtered(i);
        const Plateaus rf = in.refit(i);
        auto fail = [&](int64_t code, int64_t frame) {
            fault.code = code;
            fault.trace = i;
            fault.frame = frame;
        };
        phot_r.fill(phot, T);
        if (has[CK]) ck_r.fill(in.ck + i * T, T);
        if (need_tf) {
            tf_r.fill(tf.height, tf.n);
            std::fill(tf_start.begin(), tf_start.end(), 0);
            for (int32_t k = 0; k < tf.n; k++) {
                if (tf.start[k] >= 0 && tf.start[k] < T) {
                    tf_start[tf.start[k]] = 1;
                }
            }
        }
        if (has[REFIT]) {
            rf_r.fill(rf.height, rf.n);
            std::fill(rf_start.begin(), rf_start.end(), 0);
            for (int32_t k = 0; k < rf.n; k++) {
                if (rf.start[k] >= 0 && rf.start[k] < T) {
                    rf_start[rf.start[k]] = 1;
                }
            }
        }
        // The step-fit cells from frame f's last step and plateau; false
        // where no plateau holds f (frame_plateau's None, a TypeError).
        std::string r2_text;
        auto step_cells_at = [&](int64_t f) {
            int32_t p = tf.at(f);
            if (p < 0) return false;
            int32_t s = tf.last_step(f);
            Text t;
            t.put(",", 1);
            if (s >= 0) t.put_int(s); else t.put("None", 4);
            t.put(",", 1);
            tf_r.put(t, p);
            t.put(",", 1);
            if (s >= 0) tf_r.put(t, s); else t.put("None", 4);
            t.put(",", 1);
            t.put_int(int64_t{tf.stop[p]} - tf.start[p] + 1);
            t.put(",", 1);
            t.put(r2_text);
            step_cells = std::move(t.s);
            return true;
        };
        if (in.step_fits) {
            if (tf.at(0) < 0) {
                fail(NO_PLATEAU_TYPE_ERROR, 0);
                return;
            }
            double r2 = 0.0;
            int64_t frame = -1;
            int64_t code = r_squared(phot, T, tf, in.neumaier, &r2, &frame);
            if (code != OK) {
                fail(code, frame);
                return;
            }
            Text t;
            t.put_double(r2);
            r2_text = std::move(t.s);
            step_cells_at(0);
        }
        {
            Text t;
            t.put_int(i);
            t.put(",", 1);
            t.put_int(in.h0[i]);
            t.put(",", 1);
            t.put_int(in.w0[i]);
            t.put(",", 1);
            prefix = std::move(t.s);
        }
        for (auto& h : held_set) h = false;
        for (int64_t f = 0; f < T; f++) {
            out.put(prefix);
            out.put_int(f);
            out.put(",", 1);
            phot_r.put(out, f);
            if (in.step_fits) {
                if (tf_start[f] && !step_cells_at(f)) {
                    fail(NO_PLATEAU_TYPE_ERROR, f);
                    return;
                }
                out.put(step_cells);
            }
            // Hold each plateau intermediate from its plateaus' starts.
            if (has[REFIT] && rf_start[f]) {
                int32_t k = rf.at(f);
                if (k < 0) {
                    fail(REFIT_VALUE_ERROR, f);
                    return;
                }
                held[REFIT] = rf_r.str(k);
                held_set[REFIT] = true;
            }
            if (has[T_FILTERED] && tf_start[f]) {
                int32_t k = tf.at(f);
                if (k < 0) {
                    fail(T_FILTERED_VALUE_ERROR, f);
                    return;
                }
                held[T_FILTERED] = tf_r.str(k);
                held_set[T_FILTERED] = true;
            }
            for (int32_t c = 0; c < in.n_columns; c++) {
                out.put(",", 1);
                switch (in.columns[c]) {
                    case CK: ck_r.put(out, f); break;
                    case PHOTOMETRIES: phot_r.put(out, f); break;
                    default:
                        if (held_set[in.columns[c]]) {
                            out.put(held[in.columns[c]]);
                        } else {
                            out.put("None", 4);
                        }
                }
            }
            out.put("\r\n", 2);
        }
    }
}

bool write_all(int fd, const char* p, size_t n) {
    while (n > 0) {
        ssize_t w = ::write(fd, p, n);
        if (w < 0) {
            if (errno == EINTR) continue;
            return false;
        }
        p += w;
        n -= static_cast<size_t>(w);
    }
    return true;
}

}  // namespace

// Rows formatted before a write: bounds the text held in memory (~165
// bytes a row with every column) whatever the movie's size.
constexpr int64_t ROUND_ROWS = int64_t{1} << 19;

// Writes the header, then the rows of N traces of T frames, to the open
// file descriptor fd: in rounds of whole traces, each round's traces split
// into contiguous blocks over n_threads threads and the blocks written in
// order. Returns the rows written (N * T); or -1 with fault = {code,
// trace, frame} of the first trace at fault, the file holding the rows of
// the rounds before its own; or -2 with fault[0] = errno if a write
// failed.
extern "C" int64_t ttcsv_write(
    int32_t fd, const char* header, int64_t header_len, int64_t N,
    int64_t T, const int64_t* h0, const int64_t* w0, const double* phot,
    const double* ck, const int32_t* rf_n, const int32_t* rf_s,
    const int32_t* rf_e, const double* rf_h, int64_t rf_w,
    const int32_t* tf_n, const int32_t* tf_s, const int32_t* tf_e,
    const double* tf_h, int64_t tf_w, int32_t include_step_fits,
    const int32_t* columns, int32_t n_columns, int32_t neumaier,
    int32_t n_threads, int64_t* fault) {
    Inputs in{N, T, h0, w0, phot, ck, rf_n, rf_s, rf_e, rf_h, rf_w,
              tf_n, tf_s, tf_e, tf_h, tf_w, include_step_fits != 0,
              columns, n_columns, neumaier != 0};
    if (!write_all(fd, header, static_cast<size_t>(header_len))) {
        fault[0] = errno;
        return -2;
    }
    const int64_t per_round =
        std::max<int64_t>(1, ROUND_ROWS / std::max<int64_t>(T, 1));
    for (int64_t first = 0; first < N; first += per_round) {
        const int64_t last = std::min(first + per_round, N);
        const int64_t nt = std::max<int64_t>(
            1, std::min<int64_t>(n_threads, last - first));
        const int64_t chunk = (last - first + nt - 1) / nt;
        std::vector<Text> texts(static_cast<size_t>(nt));
        std::vector<Fault> faults(static_cast<size_t>(nt));
        if (nt == 1) {
            format_block(in, first, last, texts[0], faults[0]);
        } else {
            std::vector<std::thread> threads;
            for (int64_t k = 0; k < nt; k++) {
                int64_t lo = first + k * chunk;
                int64_t hi = std::min(lo + chunk, last);
                if (lo >= hi) break;
                threads.emplace_back(format_block, std::cref(in), lo, hi,
                                     std::ref(texts[k]),
                                     std::ref(faults[k]));
            }
            for (auto& t : threads) t.join();
        }
        for (const Fault& f : faults) {
            if (f.code != OK) {
                fault[0] = f.code;
                fault[1] = f.trace;
                fault[2] = f.frame;
                return -1;
            }
        }
        for (const Text& t : texts) {
            if (!write_all(fd, t.s.data(), t.s.size())) {
                fault[0] = errno;
                return -2;
            }
        }
    }
    return N * T;
}

// Testing hooks: repr(float) of n doubles, end to end in out (24 bytes a
// value suffice), with each value's end offset; and the R^2 and the mean
// of each of N rows (r2 NaN and code in codes where the class method
// raises).
extern "C" void ttcsv_format_doubles(const double* v, int64_t n, char* out,
                                     int64_t* ends) {
    char* p = out;
    for (int64_t i = 0; i < n; i++) {
        p = pyrepr::put_double(p, v[i]);
        ends[i] = p - out;
    }
}

extern "C" void ttcsv_r_squared(const double* phot, int64_t N, int64_t T,
                                const int32_t* tf_n, const int32_t* tf_s,
                                const int32_t* tf_e, const double* tf_h,
                                int64_t tf_w, int32_t neumaier, double* r2,
                                double* mean, int64_t* codes) {
    for (int64_t i = 0; i < N; i++) {
        Plateaus tf{tf_s + i * tf_w, tf_e + i * tf_w, tf_h + i * tf_w,
                    tf_n[i]};
        int64_t frame = -1;
        r2[i] = NAN;
        codes[i] = r_squared(phot + i * T, T, tf, neumaier != 0, r2 + i,
                             &frame);
        mean[i] = np_mean(phot + i * T, T);
    }
}
