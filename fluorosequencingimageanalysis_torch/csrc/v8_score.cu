// v8 lognormal scoring: every trace against every candidate fluor-count
// sequence, keeping only the winner.
//
// Replaces the XLA composition of
//   fluorosequencingimageanalysis_tpu/ops/lognormal.py :: _score_batch
// which is shaped for a TPU's matrix unit: it turns the table walk into two
// (T, F*nv) @ (F*nv, S) one-hot matrix products, writes both (T, S) float32
// results to device memory and reads them back for a masked argmax. Here
// nothing of size (T, S) exists: a trace's F*nv contributions sit in shared
// memory (an invalid pair as a NaN), the table is walked once per trace,
// and a running (key, index, raw score) is kept in registers.
//
// What bounds it on an H100: operations, not bytes. At T = 100,000, F = 12,
// nv = 6, S = 6,188 the inputs and outputs are 37 MB (11 us at 3.35 TB/s)
// but the walk is T*S*F = 7.4e9 float32 adds (0.11 ms at 67 TFLOP/s), and
// each add comes with a table byte and a shared-memory lookup.
//
// The design (v8_score.cuh holds the walk itself): one warp per trace, 8
// traces per block; the table is stored frame-major and padded, so a lane
// reads the values of 4 neighbouring sequences at one frame as one 32-bit
// word through the read-only cache (74 KB at the usual shape, so it stays
// in L1/L2; nothing requires it to fit shared memory, and a 2e6-sequence
// table of allow_upsteps walks the same way); validity rides the sum (one
// lookup per pair, not two, and no OR); lookups index shared memory at
// f*nv + v, so lanes that differ in v hit different banks and lanes that
// agree are a broadcast. Only float32 adds in frame order touch a score, so
// the result equals the plain twin's (ops/fused_lognormal.py::
// v8_score_plain) bit for bit; lanes are merged by (key, lowest index).
// Measured on an NVIDIA H100 80GB HBM3 (700 W limit) at that shape: 2.42 ms
// in two launches, 4.6% of the 0.111 ms bound; 32 registers, no spills; the
// twin 99.9 ms, the matmul form 12.7 ms. PERF.md section 6 has the runs and
// what was tried.

#include <cuda_runtime.h>

#include "v8_score.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * v8::LANES;

__global__ void __launch_bounds__(THREADS)
v8_score_kernel(const float* __restrict__ contrib,
                const uint8_t* __restrict__ invalid,
                const uint8_t* __restrict__ tab_t,
                const uint8_t* __restrict__ seq_ok, int T, int F, int nv,
                int S_pad, int* __restrict__ best_idx,
                uint8_t* __restrict__ found,
                float* __restrict__ best_logscore) {
  extern __shared__ float smem[];
  const int n = F * nv;
  const int warp = threadIdx.x / v8::LANES;
  const int lane = threadIdx.x % v8::LANES;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= T) return;  // whole warps leave; only warp-level syncs below

  float* c = smem + warp * n;
  const size_t base = static_cast<size_t>(t) * n;
  for (int i = lane; i < n; i += v8::LANES)
    c[i] = v8::mark(contrib[base + i], invalid[base + i]);
  __syncwarp();

  v8::Best best = v8::none();
  v8::walk_lane(c, tab_t, seq_ok, F, nv, S_pad, lane, &best);

  constexpr unsigned FULL = 0xffffffffu;
  for (int off = v8::LANES / 2; off > 0; off >>= 1) {
    v8::Best other;
    other.key = __shfl_down_sync(FULL, best.key, off);
    other.idx = __shfl_down_sync(FULL, best.idx, off);
    other.raw = __shfl_down_sync(FULL, best.raw, off);
    if (v8::beats(other, best)) best = other;
  }
  if (lane == 0) {
    const bool any = best.key > -INFINITY;
    found[t] = any ? 1 : 0;
    best_idx[t] = any ? best.idx : 0;
    best_logscore[t] =
        any ? best.raw
            : v8::raw_score(contrib + base, tab_t, F, nv, S_pad, 0);
  }
}

}  // namespace

// Bytes of dynamic shared memory a block needs for traces of F*nv entries.
extern "C" int v8_score_smem_bytes(int F, int nv) {
  return WARPS * F * nv * static_cast<int>(sizeof(float));
}

// contrib: (T, F*nv) float32; invalid: (T, F*nv) bytes, 0 or 1; tab_t:
// (F, S_pad) bytes, values < nv; seq_ok: (S_pad,) bytes; S_pad a multiple
// of 4. Outputs: best_idx (T,) int32, found (T,) bytes, best_logscore (T,)
// float32. All contiguous on the current device. Returns cudaGetLastError().
extern "C" int v8_score_launch(const float* contrib, const uint8_t* invalid,
                               const uint8_t* tab_t, const uint8_t* seq_ok,
                               int T, int F, int nv, int S_pad, int* best_idx,
                               uint8_t* found, float* best_logscore,
                               void* stream) {
  if (T == 0) return 0;
  const int blocks = (T + WARPS - 1) / WARPS;
  v8_score_kernel<<<blocks, THREADS, v8_score_smem_bytes(F, nv),
                    static_cast<cudaStream_t>(stream)>>>(
      contrib, invalid, tab_t, seq_ok, T, F, nv, S_pad, best_idx, found,
      best_logscore);
  return static_cast<int>(cudaGetLastError());
}
