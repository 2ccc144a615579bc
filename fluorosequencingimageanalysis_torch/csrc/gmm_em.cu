// Kernel E: every round of the batched 1D Gaussian-mixture EM of every
// (group, component count, restart) model, in one launch.
//
// Replaces the XLA composition
//   fluorosequencingimageanalysis_tpu/ops/gmm_batch.py :: _em_batched
// (:53-108 there; not a Pallas kernel): a lax.fori_loop of n_iter rounds,
// each a lax.scan over data chunks of ~15 whole-array operations, then a
// final log-likelihood scan. Its plain torch form issues ~30 launches per
// chunk and round (ops/gmm_batch.py::_em_plain, the twin).
//
// What bounds it on an H100: not bytes. The data are (G, N) float32, read
// once per round from L2 (12 x 100,000 x 4 B = 4.8 MB stays resident); the
// models are a few floats each. Per point, model and round it needs k
// expf and one logf (special-function unit, 16 a clock per SM) and ~13
// float32 operations per component: at 12 groups x 100,000 points x 600
// models x 101 passes, ~3e10 special-function operations (~7 ms) and
// ~3e11 float32 operations (~5 ms at 67 TFLOP/s). chip_smoke.py computes
// the bound from the run's shapes.
//
// The design, simple and right first: one block of 128 threads per model
// (G x B blocks; at 128 threads five blocks fit an SM, so 600 models are
// one wave on 132 SMs); the model's w, mu, var and active mask in shared
// memory, copied to registers for each pass; each round a strided pass of
// the block over the group's points, accumulating the per-thread (Nk, Sk,
// Qk) and the log-likelihood in registers; a fixed-order tree reduction
// through shared memory (no atomics: a run repeats bit for bit); the
// M-step on K threads; all n_iter rounds and the final log-likelihood pass
// in one launch. Inactive components and padded points are skipped, which
// is exact (their responsibilities and weights are exactly 0 in the
// twin). The per-point arithmetic is gmm_em.cuh's, the twin's operation
// for operation; the pass keeps nvcc's FMA contraction and the sums run in
// another order than the twin's, so the two agree within a tolerance, not
// bit for bit. The per-point work (2k expf, k IEEE divisions, one logf)
// is what a later, faster form would cut: one reciprocal per component
// and round, and resp = e / s in place of the second exp.

#include <cuda_runtime.h>

#include "gmm_em.cuh"

namespace {

constexpr int THREADS = 128;

struct DeviceExp {
  __host__ __device__ float operator()(float x) const { return expf(x); }
};

struct DeviceLog {
  __host__ __device__ float operator()(float x) const { return logf(x); }
};

template <int K>
__global__ void __launch_bounds__(THREADS, 5)
gmm_em_kernel(const float* __restrict__ z, const int* __restrict__ counts,
              int N, int B, const float* __restrict__ w0,
              const float* __restrict__ mu0, const float* __restrict__ var0,
              const unsigned char* __restrict__ mask, int n_iter, float reg,
              float* __restrict__ w_out, float* __restrict__ mu_out,
              float* __restrict__ var_out, float* __restrict__ ll_out) {
  constexpr int NSTAT = 3 * K + 1;  // Nk, Sk, Qk per component; loglik
  __shared__ float s_w[K], s_mu[K], s_var[K], s_wraw[K];
  __shared__ bool s_act[K];
  __shared__ float s_red[NSTAT][THREADS];

  const int model = blockIdx.x;
  const int t = threadIdx.x;
  const int g = model / B;
  const float* zg = z + static_cast<size_t>(g) * N;
  const int n = min(counts[g], N);
  if (t < K) {
    const size_t o = static_cast<size_t>(model) * K + t;
    s_w[t] = w0[o];
    s_mu[t] = mu0[o];
    s_var[t] = var0[o];
    s_act[t] = mask[o] != 0;
  }
  __syncthreads();

  for (int it = 0;; ++it) {
    gmm::Model<K> m;
    gmm::prepare<K>(s_w, s_mu, s_var, s_act, DeviceLog(), &m);
    float nk[K], sk[K], qk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) nk[k] = sk[k] = qk[k] = 0.0f;
    float ll = 0.0f;
    for (int i = t; i < n; i += THREADS) {
      const float x = __ldg(zg + i);
      const float xx = x * x;
      float resp[K];
      ll += gmm::point<K>(m, x, DeviceExp(), DeviceLog(), resp);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!m.act[k]) continue;
        nk[k] += resp[k];
        sk[k] += resp[k] * x;
        qk[k] += resp[k] * xx;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s_red[k][t] = nk[k];
      s_red[K + k][t] = sk[k];
      s_red[2 * K + k][t] = qk[k];
    }
    s_red[3 * K][t] = ll;
    __syncthreads();
    for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
      if (t < stride) {
#pragma unroll
        for (int s = 0; s < NSTAT; ++s) s_red[s][t] += s_red[s][t + stride];
      }
      __syncthreads();
    }
    if (it == n_iter) break;
    // The M-step, one thread per component.
    float mu = 0.0f, var = 1.0f;
    if (t < K)
      gmm::component_update(s_red[t][0], s_red[K + t][0],
                            s_red[2 * K + t][0], static_cast<float>(n), reg,
                            s_act[t], &mu, &var, &s_wraw[t]);
    __syncthreads();
    if (t < K) {
      float w;
      gmm::component_finish<K>(s_wraw, t, s_act[t], &w, &mu, &var);
      s_w[t] = w;
      s_mu[t] = mu;
      s_var[t] = var;
    }
    __syncthreads();
  }

  if (t < K) {
    const size_t o = static_cast<size_t>(model) * K + t;
    w_out[o] = s_w[t];
    mu_out[o] = s_mu[t];
    var_out[o] = s_var[t];
  }
  if (t == 0) ll_out[model] = s_red[3 * K][0];
}

template <int K>
int launch(const float* z, const int* counts, int G, int N, int B,
           const float* w0, const float* mu0, const float* var0,
           const unsigned char* mask, int n_iter, float reg, float* w,
           float* mu, float* var, float* ll, cudaStream_t stream) {
  gmm_em_kernel<K><<<G * B, THREADS, 0, stream>>>(
      z, counts, N, B, w0, mu0, var0, mask, n_iter, reg, w, mu, var, ll);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z: (G, N) float32 standardised data, counts: (G,) int32 valid points of
// each group (a prefix of its row); w0, mu0, var0: (G, B, K) float32
// starts; mask: (G, B, K) bool (one byte each), the active components.
// Outputs: w, mu, var (G, B, K) and ll (G, B) float32. All contiguous on
// the current device; 1 <= K <= gmm::KMAX. Returns cudaGetLastError().
extern "C" int gmm_em_launch(const float* z, const int* counts, int G, int N,
                             int B, int K, const float* w0, const float* mu0,
                             const float* var0, const unsigned char* mask,
                             int n_iter, float reg, float* w, float* mu,
                             float* var, float* ll, void* stream) {
  if (G == 0 || B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(z, counts, G, N, B, w0, mu0, var0, mask, n_iter,
                             reg, w, mu, var, ll, s);
    case 2: return launch<2>(z, counts, G, N, B, w0, mu0, var0, mask, n_iter,
                             reg, w, mu, var, ll, s);
    case 3: return launch<3>(z, counts, G, N, B, w0, mu0, var0, mask, n_iter,
                             reg, w, mu, var, ll, s);
    case 4: return launch<4>(z, counts, G, N, B, w0, mu0, var0, mask, n_iter,
                             reg, w, mu, var, ll, s);
    case 5: return launch<5>(z, counts, G, N, B, w0, mu0, var0, mask, n_iter,
                             reg, w, mu, var, ll, s);
    case 6: return launch<6>(z, counts, G, N, B, w0, mu0, var0, mask, n_iter,
                             reg, w, mu, var, ll, s);
    case 7: return launch<7>(z, counts, G, N, B, w0, mu0, var0, mask, n_iter,
                             reg, w, mu, var, ll, s);
    case 8: return launch<8>(z, counts, G, N, B, w0, mu0, var0, mask, n_iter,
                             reg, w, mu, var, ll, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
