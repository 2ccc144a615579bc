// Quality-ranked non-max suppression of competing PSF fits: one block per
// image, the rival search over spatial bins, the whole keep/suppress
// fixpoint on the card.
//
// Replaces no TPU kernel: the JAX package's consolidate
// (fluorosequencingimageanalysis_tpu/ops/consolidate.py:56-124) is an XLA
// lax.while_loop over a materialised (N, N) rival adjacency, and the
// port's plain twin (ops/consolidate.py::consolidate_plain) is the same
// adjacency in PyTorch with a host read of "any undecided?" each round.
// At N = 8,192 that writes and rereads a float distance matrix and several
// bool matrices of 2^26 entries an image, and the calling thread waits
// for the card between rounds. The work the rule needs is small: rivals
// lie within the radius (4 px), so a fit's rivals are the few fits in its
// 3x3 neighbouring cells of side ~radius, and the fixpoint takes a handful
// of rounds.
//
// What bounds it on an H100: latency, not bytes or operations. It reads
// 13 bytes a fit (center, R^2, valid) and writes 1, 0.9 MB for 8 images of
// 8,192 fits, 0.3 us at 3.35 TB/s; a round tests ~10^5 neighbour pairs an
// image. What the time is made of is the chain of block-wide steps (the
// bounding box, the bin counts, their prefix sum, the fill, then one
// barrier a round) and each round's dependent loads.
//
// The design: one launch for all (B, N) images, one block of up to 1,024
// threads an image (the thread count from N). The block bins its valid
// fits (consolidate.cuh: the grid, the cell index, the decision) by a
// counting sort whose counts live in shared memory (64 KB, hence the
// dynamic shared memory), and copies each binned fit's center, score,
// index and candidate pixel into scratch in cell order, so that a cell's
// fits are contiguous (L1 holds an image's 8,192 fits). Then rounds of
// Jacobi steps over two state buffers until __syncthreads_or finds no
// undecided fit: each undecided fit rescans its 3x3 cells against the
// previous round's states. Nothing of a fixed capacity is kept per fit, so
// any density is right, every fit in one cell included. The mask and each
// image's round count are written to device memory; nothing is read back
// to the host.
// Measured on an NVIDIA H100 80GB HBM3 (700 W limit): 0.18-0.19 ms for 8
// images of 8,192 fits and 0.15-0.18 ms for 96 of 4,096, against 32.5 and
// 90 ms for the plain twin on the same card; 63 registers, no spills.
// PERF.md section 6 has the runs.

#include <cuda_runtime.h>
#include <math.h>

#include "consolidate.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the sum. Ends on a barrier.
__device__ int block_exclusive_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < warps) warp_sums[lane] = s;
    if (lane == warps - 1) *total = s;
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  __syncthreads();
  return before;
}

__global__ void __launch_bounds__(kMaxThreads)
consolidate_kernel(const float* __restrict__ center_h,
                   const float* __restrict__ center_w,
                   const float* __restrict__ r2,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ cand_h,
                   const float* __restrict__ cand_w, int n, double radius,
                   float* sorted, int* order, unsigned char* state,
                   unsigned char* __restrict__ keep,
                   int* __restrict__ rounds_out) {
  extern __shared__ int cell_end[];  // nms::kMaxCells counts, then ends
  __shared__ float box[4][32];
  __shared__ int warp_sums[32];
  __shared__ int binned_total;
  __shared__ nms::Grid grid;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  const size_t at = static_cast<size_t>(blockIdx.x) * n;
  center_h += at;
  center_w += at;
  r2 += at;
  valid += at;
  keep += at;
  const bool gated = cand_h != nullptr;
  if (gated) {
    cand_h += at;
    cand_w += at;
  }
  float* s_h = sorted + at * (gated ? 5 : 3);
  float* s_w = s_h + n;
  float* s_score = s_w + n;
  float* s_ch = gated ? s_score + n : nullptr;
  float* s_cw = gated ? s_ch + n : nullptr;
  int* s_idx = order + at;
  unsigned char* cur = state + 2 * at;
  unsigned char* nxt = cur + n;

  // radius^2 and the gate in float32, as the plain path rounds them.
  const float rad = static_cast<float>(radius);
  const float rad2 = rad * rad;
  const float gate = static_cast<float>(radius + 2.0);
  const bool every_pair = isinf(rad2);

  // The bounding box of the binned centers; a valid fit that goes into no
  // cell rivals nothing and is kept.
  float lo_h = INFINITY, hi_h = -INFINITY, lo_w = INFINITY, hi_w = -INFINITY;
  int any_valid = 0;
  for (int i = tid; i < n; i += nt) {
    const bool v = valid[i] != 0;
    const float h = center_h[i], w = center_w[i];
    const bool in_cell = v && nms::binned(h, w, every_pair);
    keep[i] = v && !in_cell;
    any_valid |= v;
    if (in_cell && !every_pair) {
      lo_h = fminf(lo_h, h);
      hi_h = fmaxf(hi_h, h);
      lo_w = fminf(lo_w, w);
      hi_w = fmaxf(hi_w, w);
    }
  }
  lo_h = warp_min(lo_h);
  hi_h = warp_max(hi_h);
  lo_w = warp_min(lo_w);
  hi_w = warp_max(hi_w);
  if (lane == 0) {
    box[0][warp] = lo_h;
    box[1][warp] = hi_h;
    box[2][warp] = lo_w;
    box[3][warp] = hi_w;
  }
  __syncthreads();
  if (warp == 0) {
    lo_h = warp_min(lane < warps ? box[0][lane] : INFINITY);
    hi_h = warp_max(lane < warps ? box[1][lane] : -INFINITY);
    lo_w = warp_min(lane < warps ? box[2][lane] : INFINITY);
    hi_w = warp_max(lane < warps ? box[3][lane] : -INFINITY);
    if (lane == 0)
      grid = nms::make_grid(lo_h, hi_h, lo_w, hi_w, radius, every_pair);
  }
  __syncthreads();
  const nms::Grid g = grid;
  const int cells = g.gh * g.gw;

  // Counting sort into cells: counts, their exclusive prefix sum (each
  // thread a run of consecutive cells), then the fill, which moves each
  // cell's start to its end.
  for (int c = tid; c < cells; c += nt) cell_end[c] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    const float h = center_h[i], w = center_w[i];
    if (valid[i] && nms::binned(h, w, every_pair))
      atomicAdd(&cell_end[nms::cell_of(g, h, w)], 1);
  }
  __syncthreads();
  const int run = (cells + nt - 1) / nt;
  const int c0 = min(tid * run, cells), c1 = min(c0 + run, cells);
  int count = 0;
  for (int c = c0; c < c1; ++c) count += cell_end[c];
  int start = block_exclusive_sum(count, warp_sums, &binned_total);
  for (int c = c0; c < c1; ++c) {
    const int k = cell_end[c];
    cell_end[c] = start;
    start += k;
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    const float h = center_h[i], w = center_w[i];
    if (!(valid[i] && nms::binned(h, w, every_pair))) continue;
    const int p = atomicAdd(&cell_end[nms::cell_of(g, h, w)], 1);
    const float q = r2[i];
    s_h[p] = h;
    s_w[p] = w;
    s_score[p] = isnan(q) ? -INFINITY : q;
    s_idx[p] = i;
    if (gated) {
      s_ch[p] = cand_h[i];
      s_cw[p] = cand_w[i];
    }
    cur[p] = nms::kUndecided;
  }
  const int m = binned_total;
  const nms::Sorted s{s_h, s_w, s_score, s_idx, s_ch, s_cw, cell_end};

  // The fixpoint. The barrier of each round's __syncthreads_or also
  // orders its writes of nxt before the next round's reads.
  int rounds = 0;
  bool more = __syncthreads_or(any_valid);
  while (more) {
    ++rounds;
    int left = 0;
    for (int p = tid; p < m; p += nt) {
      unsigned char st = cur[p];
      if (st == nms::kUndecided) st = nms::decide(s, g, cur, p, rad2, gate);
      nxt[p] = st;
      left |= st == nms::kUndecided;
    }
    unsigned char* t = cur;
    cur = nxt;
    nxt = t;
    more = __syncthreads_or(left);
  }
  for (int p = tid; p < m; p += nt) keep[s_idx[p]] = cur[p] == nms::kKept;
  if (tid == 0) rounds_out[blockIdx.x] = rounds;
}

}  // namespace

// center_h, center_w, r2: (B, n) float32; valid: (B, n) bool; cand_h,
// cand_w: (B, n) float32 candidate pixels, or both null (no window gate).
// Scratch: sorted (B, 5 or 3 with the gate or without, n) float32, order
// (B, n) int32, state (B, 2, n) uint8. Out: keep (B, n) bool, rounds (B,)
// int32. Returns the CUDA error of the launch.
extern "C" int consolidate_launch(const float* center_h, const float* center_w,
                                  const float* r2, const unsigned char* valid,
                                  const float* cand_h, const float* cand_w,
                                  int B, int n, double radius, float* sorted,
                                  int* order, unsigned char* state,
                                  unsigned char* keep, int* rounds,
                                  void* stream) {
  if (B == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  const int smem = nms::kMaxCells * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      consolidate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n >= kMaxThreads ? kMaxThreads : (n + 31) / 32 * 32;
  consolidate_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      center_h, center_w, r2, valid, cand_h, cand_w, n, radius, sorted, order,
      state, keep, rounds);
  return static_cast<int>(cudaGetLastError());
}
