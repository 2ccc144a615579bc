// Candidate map: 5x5 median background removal + 5x5 template correlation.
//
// Replaces the Pallas TPU kernel
//   fluorosequencingimageanalysis_tpu/ops/pallas_candidates.py
//   :: _candidate_map_fused_impl / _make_candidate_kernel / _median25
// and computes, for every pixel of a (B, H, W) float32 batch,
//   med = 5x5 median with numpy-'symmetric' (scipy 'reflect') padding,
//   mf  = x - min(med, x), taken as 0 outside the image,
//   cm  = max(sum_{a,b} t[a][b] * mf[y + a - 2][x + b - 2], 0).
//
// What bounds it on an H100: the SM's min/max issue rate, not memory. Each
// pixel is read and written once (8 bytes; 67 MB for 32x512x512, 20 us at
// 3.35 TB/s), but its median costs a comparator network and its
// correlation 25 FMAs. Sorting all 25 values would take 300 exchanges (600
// min/max); the median needs far fewer.
//
// The design: (1) median25.cuh's selection network, 174 min/max, and exact
// like a sort; (2) 64x64 output tiles, so the median runs on 68x68 pixels
// per 4096 outputs (1.13x, against 1.27x for 32x32 tiles); (3) 578
// threads, so the 4624 medians of a tile take exactly 8 rounds, and the
// 4096 outputs exactly 8 rounds of 512 threads (the other 66 have
// finished): no round runs mostly idle. One block stages its input plus a
// 4-pixel halo (2 for the median, 2 for the correlation) in shared memory,
// computing the reflected indices while loading; each thread then takes
// medians in registers and writes mf into a second shared tile (zeros
// outside the image), which the 25 taps read. The template is a kernel
// argument (25 floats), so any 5x5 template works without recompiling.
// The tap loop keeps FMA contraction and its order: with it the output is
// bitwise equal to the plain twin's.
// Measured on an NVIDIA H100 80GB HBM3 (700 W limit), 32x512x512: 0.22 ms,
// 13% of the 0.028 ms bound counted at the FMA rate; 40 registers, no
// spills. Float32 min/max issue at half that rate on sm_90, so the 174
// min/max per pixel alone need ~0.1 ms: fewer of them (work shared between
// neighbouring windows) is the next lever. PERF.md section 6 has the runs.

#include <cuda_runtime.h>

#include "median25.cuh"

namespace {

constexpr int TILE = 64;
constexpr int HALO = 4;                  // 2 (median) + 2 (correlation)
constexpr int IN_T = TILE + 2 * HALO;    // 72: staged input rows/cols
constexpr int MF_T = TILE + 4;           // 68: mf rows/cols feeding taps
constexpr int THREADS = MF_T * MF_T / 8;  // 578: 8 median rounds each
constexpr int TAP_THREADS = 512;         // 8 output rounds each
static_assert(MF_T * MF_T == 8 * THREADS, "median rounds must be full");
static_assert(TILE * TILE == 8 * TAP_THREADS, "output rounds must be full");

struct Taps {
  float w[25];
};

// Source index of numpy 'symmetric' padding (edge sample repeats).
__device__ __forceinline__ int reflect(int i, int n) {
  const int period = 2 * n;
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - 1 - i;
}

__global__ void __launch_bounds__(THREADS)
candidate_map_kernel(const float* __restrict__ img, float* __restrict__ out,
                     int H, int W, Taps taps) {
  __shared__ float s_in[IN_T][IN_T];
  __shared__ float s_mf[MF_T][MF_T];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const float* src = img + static_cast<size_t>(b) * H * W;
  const int tid = threadIdx.x;

  // Input rows/cols y0-4 .. y0+67 with symmetric reflection.
  for (int k = tid; k < IN_T * IN_T; k += THREADS) {
    const int r = k / IN_T;
    const int c = k % IN_T;
    const int gy = reflect(y0 - HALO + r, H);
    const int gx = reflect(x0 - HALO + c, W);
    s_in[r][c] = src[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();

  // mf at rows/cols y0-2 .. y0+65; s_mf[r][c] is centred on s_in[r+2][c+2].
#pragma unroll 1
  for (int k = tid; k < MF_T * MF_T; k += THREADS) {
    const int r = k / MF_T;
    const int c = k % MF_T;
    const int gy = y0 - 2 + r;
    const int gx = x0 - 2 + c;
    float mf = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      float v[25];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 5; ++j) v[i * 5 + j] = s_in[r + i][c + j];
      }
      const float x = v[12];
      mf = x - fminf(median25::select<median25::FloatMinMax>(v), x);
    }
    s_mf[r][c] = mf;
  }
  __syncthreads();
  if (tid >= TAP_THREADS) return;

  for (int k = tid; k < TILE * TILE; k += TAP_THREADS) {
    const int r = k / TILE;
    const int c = k % TILE;
    const int gy = y0 + r;
    const int gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 5; ++a) {
#pragma unroll
      for (int bb = 0; bb < 5; ++bb) acc += taps.w[a * 5 + bb] * s_mf[r + a][c + bb];
    }
    out[(static_cast<size_t>(b) * H + gy) * W + gx] = fmaxf(acc, 0.0f);
  }
}

}  // namespace

// images, out: (B, H, W) float32, contiguous, on the current device.
// taps: 25 host floats, row-major 5x5 template. Returns cudaGetLastError().
extern "C" int candidate_map_launch(const float* images, float* out, int B,
                                    int H, int W, const float* taps,
                                    void* stream) {
  Taps t;
  for (int i = 0; i < 25; ++i) t.w[i] = taps[i];
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  candidate_map_kernel<<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(images, out, H,
                                                              W, t);
  return static_cast<int>(cudaGetLastError());
}
