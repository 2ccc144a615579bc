// The spatial bins and the keep/suppress decision of the NMS, for nvcc and
// g++ alike.
//
// The rule (ops/consolidate.py::consolidate_plain): fit j is a rival of fit
// i when j is valid, ranks above i (score, then the lower index on ties;
// an invalid or NaN R^2 scores -inf), d2 = (h_i - h_j)^2 + (w_i - w_j)^2 <=
// radius^2 in float32, and, where candidate pixels are given, both of
// |ch_i - ch_j| and |cw_i - cw_j| are <= radius + 2. Each Jacobi round an
// undecided fit is SUPPRESSED if a rival was KEPT, stays UNDECIDED if a
// rival is still undecided, and is KEPT otherwise.
//
// Binning. Every rival pair lies in neighbouring cells of a grid whose
// cell sides are at least radius * (1 + 2^-10): a float32 d2 <= radius^2
// bounds |h_i - h_j| by radius * (1 + 3e-7), the cell index is computed in
// double from the distance to the grid's lowest center (an error of about
// 1e-13 cells), and clamping an index into the grid moves two indices no
// further apart. The grid covers the bounding box of the binned centers
// with at most kGridSide cells a side (larger cells where the box is wide),
// so its counts fit one block's shared memory. A center with a NaN or
// infinite coordinate goes into no cell: its d2 to any fit is NaN or inf,
// never <= a finite radius^2, so it rivals nothing and is kept if valid.
// Where radius^2 overflows to inf, d2 <= inf holds for every pair whose
// d2 is not NaN, at any distance: then the grid is one cell, and only a
// NaN coordinate keeps a center out of it.
//
// The float comparisons are the plain path's, operation for operation
// (the kernel is built with -fmad=false, the CPU harness with
// -ffp-contract=off), so the kernel's mask and its round count equal the
// plain path's on every input.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define NMS_FN __host__ __device__ __forceinline__
#else
#define NMS_FN inline
#endif

namespace nms {

constexpr int kGridSide = 128;                    // cells a side, at most
constexpr int kMaxCells = kGridSide * kGridSide;  // 64 KB of int32 counts
// Below this radius d2 and radius^2 are float32 subnormals, whose spacing
// (2^-149) no longer scales with the radius: the cell side stays at this
// floor (times the margin), above any distance whose square can round to
// <= radius^2 there.
constexpr double kSideFloor = 1e-19;

constexpr unsigned char kSuppressed = 0;
constexpr unsigned char kUndecided = 1;
constexpr unsigned char kKept = 2;

struct Grid {
  double lo_h, lo_w;      // the lowest binned center on each axis
  double side_h, side_w;  // cell sides
  int gh, gw;             // cells a side
};

// Whether a valid fit's center goes into a cell.
NMS_FN bool binned(float h, float w, bool every_pair_rivals) {
  return every_pair_rivals ? !(isnan(h) || isnan(w))
                           : (isfinite(h) && isfinite(w));
}

NMS_FN double axis_side(double extent, double radius) {
  double r = fabs(radius);
  if (!(r >= kSideFloor)) r = kSideFloor;  // NaN, zero and tiny radii
  const double margin_side = r * (1.0 + 1.0 / 1024.0);
  const double fit_side = extent / kGridSide;
  return fit_side > margin_side ? fit_side : margin_side;
}

NMS_FN int axis_cells(double extent, double side) {
  const double q = floor(extent / side) + 1.0;
  return q < kGridSide ? static_cast<int>(q) : kGridSide;
}

// The grid over the binned centers' box [lo_h, hi_h] x [lo_w, hi_w]; one
// cell where nothing is binned (lo > hi) or every pair rivals.
NMS_FN Grid make_grid(float lo_h, float hi_h, float lo_w, float hi_w,
                      double radius, bool every_pair_rivals) {
  Grid g;
  if (every_pair_rivals || !(lo_h <= hi_h && lo_w <= hi_w)) {
    g.lo_h = g.lo_w = 0.0;
    g.side_h = g.side_w = 1.0;
    g.gh = g.gw = 1;
    return g;
  }
  const double ext_h = static_cast<double>(hi_h) - lo_h;
  const double ext_w = static_cast<double>(hi_w) - lo_w;
  g.lo_h = lo_h;
  g.lo_w = lo_w;
  g.side_h = axis_side(ext_h, radius);
  g.side_w = axis_side(ext_w, radius);
  g.gh = axis_cells(ext_h, g.side_h);
  g.gw = axis_cells(ext_w, g.side_w);
  return g;
}

// The clamped cell index on one axis of a binned coordinate x >= lo (a
// one-cell axis takes any x that is not NaN).
NMS_FN int axis_cell(float x, double lo, double side, int cells) {
  const double q = (static_cast<double>(x) - lo) / side;
  return q > 0.0 ? (q < cells - 1 ? static_cast<int>(q) : cells - 1) : 0;
}

NMS_FN int cell_of(const Grid& g, float h, float w) {
  return axis_cell(h, g.lo_h, g.side_h, g.gh) * g.gw +
         axis_cell(w, g.lo_w, g.side_w, g.gw);
}

// The fits binned in cell order: position p holds fit idx[p] with its
// center (h[p], w[p]), score and, where gated, candidate pixel (ch[p],
// cw[p]). Cell c holds positions [cell_end[c - 1], cell_end[c]).
struct Sorted {
  const float* h;
  const float* w;
  const float* score;
  const int* idx;
  const float* ch;  // null where ungated
  const float* cw;
  const int* cell_end;
};

// The state after this round of the undecided fit at position p, from the
// states of the previous round (cur).
NMS_FN unsigned char decide(const Sorted& s, const Grid& g,
                            const unsigned char* cur, int p, float rad2,
                            float gate) {
  const float hp = s.h[p], wp = s.w[p], sp = s.score[p];
  const int ip = s.idx[p];
  const int bh = axis_cell(hp, g.lo_h, g.side_h, g.gh);
  const int bw = axis_cell(wp, g.lo_w, g.side_w, g.gw);
  bool blocked = false;
  for (int ih = bh > 0 ? bh - 1 : 0; ih <= bh + 1 && ih < g.gh; ++ih) {
    for (int iw = bw > 0 ? bw - 1 : 0; iw <= bw + 1 && iw < g.gw; ++iw) {
      const int c = ih * g.gw + iw;
      const int end = s.cell_end[c];
      for (int q = c > 0 ? s.cell_end[c - 1] : 0; q < end; ++q) {
        const unsigned char state = cur[q];
        if (state == kSuppressed) continue;
        const float sq = s.score[q];
        if (!(sq > sp || (sq == sp && s.idx[q] < ip))) continue;
        const float dh = hp - s.h[q];
        const float dw = wp - s.w[q];
        if (!(dh * dh + dw * dw <= rad2)) continue;
        if (s.ch != nullptr &&
            !(fabsf(s.ch[p] - s.ch[q]) <= gate &&
              fabsf(s.cw[p] - s.cw[q]) <= gate))
          continue;
        if (state == kKept) return kSuppressed;
        blocked = true;
      }
    }
  }
  return blocked ? kUndecided : kKept;
}

}  // namespace nms
