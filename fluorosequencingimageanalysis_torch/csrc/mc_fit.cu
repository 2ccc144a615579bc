// Kernel D: the Monte-Carlo random-search PSF fit of every candidate.
//
// Replaces the XLA composition in
//   fluorosequencingimageanalysis_tpu/models/detect.py ::
//   _detect_and_fit_monte_carlo (the lax.scan over score_chunk, :762-779)
// which, sample after sample, builds the (K, 5, 5) model of every candidate,
// normalises it, and keeps a running best: n_iter rounds of whole-array
// operations, each writing and reading (K, 25) arrays in device memory.
// Here a candidate's normalised patch and its running best stay in
// registers, and each sample's model lives only in registers.
//
// What bounds it on an H100: the sampled parameters are 6 * K * n_iter
// float32 read once (0.059 ms at K = 8192, n_iter = 1000, over 3.35 TB/s);
// the arithmetic is ~12 float32 operations per pixel and sample (0.037 ms
// at 67 TFLOP/s), and each pixel's exp runs on the special-function unit.
//
// The design (mc_fit.cuh holds the per-sample body): a block holds 32
// candidates and PARTS = 16 warps; warp w scans the w-th of PARTS
// consecutive ranges of the samples for the block's candidates, so a warp
// reads each sample's parameters as 128 coalesced bytes, and the card holds
// PARTS times as many warps as one thread per candidate would give (at K =
// 8,192 that is 256 warps: 2 an SM, too few to hide the body's latency).
// The ranges' bests meet in shared memory and merge in range order
// (mc::better), which is the sequential scan's first-minimum rule. Built
// with -fmad=false: every product and sum is rounded on its own, as the
// plain twin's one operation per launch is (ops/mc_fit.py::mc_fit_plain),
// so the two agree bit for bit.
// Measured on an NVIDIA H100 80GB HBM3 (700 W limit) at K = 8,192 x 1,000:
// 4 warps a block 0.73 ms (80 registers, 16 bytes of spills), 8 warps
// 0.45 ms, 16 warps 0.45 ms (87 registers, no spills), all bit-equal to the
// twin; 16 keeps a K = 4,096 call at one block an SM.

#include <cuda_runtime.h>

#include "mc_fit.cuh"

namespace {

constexpr int CANDS = 32;  // candidates per block, one per lane
constexpr int PARTS = 16;  // warps per block, one range of samples each
constexpr int THREADS = CANDS * PARTS;

struct DeviceExp {
  __host__ __device__ float operator()(float x) const { return expf(x); }
};

struct DeviceLoad {  // through the read-only cache on the card
  __host__ __device__ float operator()(const float* p) const {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
  }
};

__global__ void __launch_bounds__(THREADS)
mc_fit_kernel(const float* __restrict__ patches,
              const float* __restrict__ samples, int K, int n_iter,
              float* __restrict__ best_p, float* __restrict__ best_norm) {
  __shared__ mc::Best parts[PARTS][CANDS];
  const int lane = threadIdx.x % CANDS;
  const int part = threadIdx.x / CANDS;
  const int k = blockIdx.x * CANDS + lane;
  mc::Best best = mc::none();
  if (k < K) {
    float patch[mc::NPIX];
#pragma unroll
    for (int p = 0; p < mc::NPIX; ++p)
      patch[p] = patches[static_cast<size_t>(k) * mc::NPIX + p];
    const size_t plane = static_cast<size_t>(n_iter) * K;
    const float* planes[mc::NPARAM];
#pragma unroll
    for (int q = 0; q < mc::NPARAM; ++q) planes[q] = samples + q * plane;
    const int s0 = static_cast<int>(
        static_cast<long long>(n_iter) * part / PARTS);
    const int s1 = static_cast<int>(
        static_cast<long long>(n_iter) * (part + 1) / PARTS);
    mc::scan(patch, planes, K, k, s0, s1, DeviceExp(), DeviceLoad(), &best);
  }
  parts[part][lane] = best;
  __syncthreads();
  if (part != 0 || k >= K) return;
  for (int w = 1; w < PARTS; ++w)
    if (mc::better(parts[w][lane], best)) best = parts[w][lane];
  best_norm[k] = best.norm;
  for (int q = 0; q < mc::NPARAM; ++q)
    best_p[static_cast<size_t>(k) * mc::NPARAM + q] = best.p[q];
}

}  // namespace

// patches: (K, 25) float32, normalised; samples: (6, n_iter, K) float32
// (H, A, h0, w0, sh, sw). Outputs: best_p (K, 6) and best_norm (K,)
// float32. All contiguous on the current device. Returns
// cudaGetLastError().
extern "C" int mc_fit_launch(const float* patches, const float* samples,
                             int K, int n_iter, float* best_p,
                             float* best_norm, void* stream) {
  if (K == 0) return 0;
  const int blocks = (K + CANDS - 1) / CANDS;
  mc_fit_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      patches, samples, K, n_iter, best_p, best_norm);
  return static_cast<int>(cudaGetLastError());
}
