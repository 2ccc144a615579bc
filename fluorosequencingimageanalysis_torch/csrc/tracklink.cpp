// Native greedy particle-tracking core.
//
// Reproduces the linking semantics of the reference's
// Experiment.greedy_particle_tracking (flexlibrary.py:679-1027) over plain
// arrays: Python-2 rounding into per-frame pixel bins, a persistent
// ancestor cache where newer frames overwrite older entries at the same
// bin, candidate pairs generated ancestor-raster-major / window-cell-
// raster-minor, a stable sort by Euclidean distance (ties resolved by
// generation order), and greedy acceptance that removes paired ancestors
// from the cache. The Python layer (pipeline/tracking.py) handles offset
// accumulation, dropout filtering, and trace assembly from the returned
// ancestor/descendant links.
//
// Exposed via ctypes (pybind11 unavailable in this image); all buffers are
// caller-allocated numpy arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline int64_t py2round(double x) {
    // Python 2 round(): halves away from zero. Exact fraction
    // comparison, NOT floor(x + 0.5) — the addition rounds a near-half
    // double up across the tie (see utils/rounding.py). Must stay
    // bit-identical to the host py2_round or pixel bins diverge.
    double ax = std::fabs(x);
    double f = std::floor(ax);
    int64_t r = static_cast<int64_t>(f) + (ax - f >= 0.5 ? 1 : 0);
    return x < 0 ? -r : r;
}

struct Pair {
    double dist;
    int32_t a_rank;   // ancestor raster rank this frame
    int32_t cell;     // window-cell raster rank
    int64_t a_cell;   // ancestor bin (flat)
    int32_t a_spot;   // global ancestor spot index
    int32_t d_spot;   // global descendant spot index
};

inline bool pair_less(const Pair& a, const Pair& b) {
    if (a.dist != b.dist) return a.dist < b.dist;
    if (a.a_rank != b.a_rank) return a.a_rank < b.a_rank;
    return a.cell < b.cell;
}

}  // namespace

extern "C" {

// Returns 0 on success; 1 if two spots of one frame share a bin (the
// reference asserts on this); the offending (frame, cell) goes to err_out.
int trk_greedy_link(const double* h, const double* w,
                    const int32_t* frame_start,  // n_frames+1 prefix sums
                    int32_t n_frames, int32_t n_spots,
                    int32_t H, int32_t W, double candidate_radius,
                    int32_t* out_ancestor, int32_t* out_descendant,
                    int64_t* err_out) {
    const int64_t n_cells = static_cast<int64_t>(H) * W;
    std::vector<int32_t> cache(n_cells, -1);   // global spot idx or -1
    std::vector<int32_t> dgrid(n_cells, -1);   // this frame's spots
    std::vector<int64_t> bins(n_spots);        // flat bin per spot
    std::vector<int64_t> touched;

    for (int32_t s = 0; s < n_spots; ++s) {
        out_ancestor[s] = -1;
        out_descendant[s] = -1;
        const int64_t bh = py2round(h[s]);
        const int64_t bw = py2round(w[s]);
        // Rounded bins must land inside the frame: callers normally run
        // discard_dropouts first, but a direct library call with stage
        // drift (h = -0.6 -> bin -1) must fail LOUDLY, not scribble out
        // of the grid vectors.
        if (bh < 0 || bh >= H || bw < 0 || bw >= W) {
            err_out[0] = -1;
            err_out[1] = s;
            return 2;
        }
        bins[s] = bh * W + bw;
    }
    // Bin-uniqueness check per frame (reference precondition).
    {
        std::vector<int32_t> seen(n_cells, -1);
        for (int32_t f = 0; f < n_frames; ++f) {
            for (int32_t s = frame_start[f]; s < frame_start[f + 1]; ++s) {
                if (seen[bins[s]] == f) {
                    err_out[0] = f;
                    err_out[1] = bins[s];
                    return 1;
                }
                seen[bins[s]] = f;
            }
        }
    }

    const int32_t pad = static_cast<int32_t>(candidate_radius) + 2;
    const int32_t win = 2 * pad + 1;
    std::vector<Pair> pairs;

    for (int32_t f = 1; f < n_frames; ++f) {
        // Merge frame f-1 into the cache (overwrites at shared bins).
        for (int32_t s = frame_start[f - 1]; s < frame_start[f]; ++s)
            cache[bins[s]] = s;
        const int32_t d0 = frame_start[f], d1 = frame_start[f + 1];
        if (d1 == d0) continue;
        touched.clear();
        for (int32_t s = d0; s < d1; ++s) {
            dgrid[bins[s]] = s;
            touched.push_back(bins[s]);
        }
        // Candidate pairs: ancestors in raster order over the cache grid,
        // window cells in raster order (clipping at edges removes cells
        // without reordering survivors, so the unclipped cell rank
        // reproduces the reference's ndenumerate walk).
        pairs.clear();
        int32_t a_rank = 0;
        for (int64_t cell = 0; cell < n_cells; ++cell) {
            const int32_t a = cache[cell];
            if (a < 0) continue;
            const int32_t ah = static_cast<int32_t>(cell / W);
            const int32_t aw = static_cast<int32_t>(cell % W);
            for (int32_t ci = 0; ci < win * win; ++ci) {
                const int32_t dh = ah - pad + ci / win;
                const int32_t dw = aw - pad + ci % win;
                if (dh < 0 || dh >= H || dw < 0 || dw >= W) continue;
                const int32_t d = dgrid[static_cast<int64_t>(dh) * W + dw];
                if (d < 0) continue;
                // sqrt(dh*dh + dw*dw), NOT std::hypot: the reference's
                // scipy euclidean uses the plain form, and hypot's
                // compensated algorithm bit-differs on knife-edge pairs
                // (the Python tracker and the test oracle match this).
                const double ddh = h[a] - h[d];
                const double ddw = w[a] - w[d];
                const double dist = std::sqrt(ddh * ddh + ddw * ddw);
                if (dist < candidate_radius)
                    pairs.push_back({dist, a_rank, ci, cell, a, d});
            }
            ++a_rank;
        }
        std::sort(pairs.begin(), pairs.end(), pair_less);
        for (const Pair& p : pairs) {
            if (cache[p.a_cell] != p.a_spot) continue;  // ancestor paired
            if (out_ancestor[p.d_spot] != -1) continue; // descendant paired
            out_ancestor[p.d_spot] = p.a_spot;
            out_descendant[p.a_spot] = p.d_spot;
            cache[p.a_cell] = -1;
        }
        for (int64_t cell : touched) dgrid[cell] = -1;
    }
    return 0;
}

}  // extern "C"
