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
// What bounds it on an H100: not bytes. The data are (G, N) float32 (12 x
// 100,000 x 4 B = 4.8 MB at config 5's mixtures); the models are a few
// floats each. Per point, model and pass it needs k exp2 and one log2
// (special-function unit, 16 a clock per SM) and ~13 float32 operations
// per component: at 12 groups x 100,000 points x 600 models x 101 passes,
// 3.0e10 special-function operations (7.25 ms) and 3.3e11 float32
// operations (4.9 ms at 67 TFLOP/s). chip_smoke.py computes the bound from
// the run's shapes.
//
// The design. The first form (one block of 4 warps per model, every pass
// reading the group's points from L2; two accurate expf, an IEEE division
// and a logf per point and component) took 88.5 ms at config 5's
// mixtures, 8% of the bound, on an NVIDIA H100 80GB HBM3 at 700 W: its
// instructions a point were ~6x the bound's special-function count, 18
// warps an SM hid little of their latency, and the k = 6 blocks set the
// time of its one wave. Now:
// - The arithmetic (gmm_em.cuh): per round and component one reciprocal of
//   the variance and the constants folded into the log2 domain; per point
//   and component a subtract, a multiply, an FMA, a max, a subtract, one
//   ex2 and three FMAs into the statistics (resp = e * (1 / s) folded
//   in); per point one lg2 and one rcp.
// - The layout: the CLUSTER blocks of a thread block cluster split one
//   group's valid points into equal slices; each block stages its slice in
//   shared memory in tiles of at most TILE_MAX points (once for all rounds
//   when it fits, else tile by tile each round), and every model of the
//   block reads each staged point, so a point read from L2 serves all of
//   them. The group's models are split into S subsets of equal work
//   (gmm::assign_subsets, by active component count), one cluster per
//   (group, subset), S as large as the card holds clusters at once. The
//   warps of a block run every model of its subset over equal shares of
//   each tile, each model's loop compiled for its own count of active
//   components (a mask need not be a prefix: the active components are
//   compacted in order, which sums exactly as the twin's masked sums do).
//   Blocks of 16 warps, two an SM: 32 warps an SM within 64 registers up
//   to K = 6, no spills.
// - The reduction: each round a warp folds its statistics by shuffles, the
//   block sums its warps in warp order, and every block of the cluster
//   reads the blocks' sums through distributed shared memory in rank order
//   and runs the same M-step: one cluster barrier a round (the block sums
//   are double buffered by round parity), no atomics, so a launch repeats
//   bit for bit.
// Measured by tools/ab_gmm_em.py at config 5's mixtures (12 x 100,000
// points, 50 models of k 2-6, K = 6, 100 rounds) on an NVIDIA H100 80GB
// HBM3 at 700 W, in turns in one call: 17.3 ms, 42% of the 7.25 ms bound,
// against 89.5 ms for the first form; clusters of 2 blocks 17.5 ms, of 8
// blocks 20.1 ms, no cluster (each block streaming its group's points
// from L2 every round) 20.2 ms. What holds it near 40%: each point and
// component still takes ~11 instructions of the float32 pipe beside its
// ex2, so the issue of ~55 instructions a point and model (k ~ 4) and the
// special-function unit's k + 2 operations share the SM, and their
// latency chains are not fully hidden at 32 warps (not measured: no ncu
// there); each of the two tiles a round costs ~1.1 ms (its barriers and
// load, and every model's warp reduction: smaller tiles measured so).
// Inactive components and padded points are skipped, which is exact
// (their responsibilities and weights are exactly 0 in the twin). The
// pass keeps nvcc's FMA contraction, the approximate special functions
// and sums in another order than the twin's, so the two agree within a
// tolerance, not bit for bit.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gmm_em.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 4;        // blocks that split one group's points
constexpr int WARPS = 16;         // warps a block
constexpr int MIN_BLOCKS = 2;     // blocks an SM the registers must allow
constexpr int UNROLL = 2;         // points a thread's loop interleaves
constexpr int TILE_MAX = 16384;   // points a block stages at once
constexpr int BMAX = 4096;        // models a group at most
constexpr int SMEM_MAX = 232448;  // shared memory a block may use
constexpr int THREADS = 32 * WARPS;

// The special functions of the E-step: ex2.approx.ftz.f32 (at most 2 ulp,
// the CUDA C++ Programming Guide's bound for exp2f, which compiles to
// ex2.approx; results below 2^-126 flush to 0), lg2.approx.ftz.f32 (its
// argument, the sum s, is at least 1: the bound of __log2f, 2^-22 absolute
// on [0.5, 2] and 2 ulp beyond) and rcp.approx.ftz.f32 (at most 1 ulp,
// PTX ISA). On the host (never called there) the library's functions.
struct DeviceExp2 {
  __host__ __device__ float operator()(float x) const {
#ifdef __CUDA_ARCH__
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
#else
    return exp2f(x);
#endif
  }
};

struct DeviceLog2 {
  __host__ __device__ float operator()(float x) const {
#ifdef __CUDA_ARCH__
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
#else
    return log2f(x);
#endif
  }
};

struct DeviceRcp {
  __host__ __device__ float operator()(float x) const {
#ifdef __CUDA_ARCH__
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
#else
    return 1.0f / x;
#endif
  }
};

// The per-round constants' log: logf, once a round and component.
struct DeviceLog {
  __host__ __device__ float operator()(float x) const { return logf(x); }
};

// A block's dynamic shared memory: the staged points (pts_len floats; at
// set-up, the subset split's scratch), then for each of its models (at
// most mmax) the warps' statistics (NST a warp), the block's sums by round
// parity (read by the cluster's other blocks), the cluster's sums, the
// parameters and raw weights by component, the round's constants of the
// active components in order (c2, mu, h2), and the model's index, active
// count and each component's compact index (-1 when inactive). Each
// address is computed where it is used from the kernel's parameters, so
// none stays in a register across the E-step's loop.
extern __shared__ float gmm_em_smem[];

template <int K>
struct Layout {
  static constexpr int NST = 3 * K + 1;  // Nk, Sk, Qk per component; ll
  int pts_len, mmax;

  static size_t bytes(int pts_len, int mmax) {
    return 4 * (static_cast<size_t>(pts_len) +
                static_cast<size_t>(mmax) *
                    (WARPS * NST + 3 * NST + 7 * K + 2 + K));
  }
  __device__ float* pts() const { return gmm_em_smem; }
  __device__ float* part() const { return pts() + pts_len; }
  __device__ float* blk(int parity) const {
    return part() + (WARPS + parity) * mmax * NST;
  }
  __device__ float* tot() const { return part() + (WARPS + 2) * mmax * NST; }
  // Per component: 0 w, 1 mu, 2 var, 3 raw weight, 4 c2, 5 mu, 6 h2.
  __device__ float* comp(int which) const {
    return part() + (WARPS + 3) * mmax * NST + which * mmax * K;
  }
  __device__ int* model() const {
    return reinterpret_cast<int*>(comp(7));
  }
  __device__ int* nact() const { return model() + mmax; }
  __device__ int* pos() const { return nact() + mmax; }
};

// One model of A active components over this thread's points of a staged
// tile (pts[threadIdx.x + THREADS * j], j >= 0, below cnt); the warp's
// statistics (Nk, Sk, Qk at offsets 0, K, 2K; the log-likelihood at 3K)
// are written to part, or added to it after the first tile.
template <int K, int A>
__device__ __forceinline__ void accumulate(const float* pts, int cnt,
                                           const float* c2, const float* mu,
                                           const float* h2, float* part,
                                           bool first) {
  gmm::Model<A> m;
#pragma unroll
  for (int j = 0; j < A; ++j) {
    m.c2[j] = c2[j];
    m.mu[j] = mu[j];
    m.h2[j] = h2[j];
    m.act[j] = true;
  }
  float nk[A], sk[A], qk[A];
#pragma unroll
  for (int j = 0; j < A; ++j) nk[j] = sk[j] = qk[j] = 0.0f;
  float ll = 0.0f;
#pragma unroll (UNROLL)
  for (int i = threadIdx.x; i < cnt; i += THREADS) {
    const float x = pts[i];
    float e[A], r;
    ll += gmm::point_terms<A>(m, x, DeviceExp2(), DeviceLog2(), DeviceRcp(),
                              e, &r);
    // resp = e * r, folded into the statistics: three FMAs a component.
    const float rx = r * x, rxx = rx * x;
#pragma unroll
    for (int j = 0; j < A; ++j) {
      nk[j] += e[j] * r;
      sk[j] += e[j] * rx;
      qk[j] += e[j] * rxx;
    }
  }
  // A butterfly: every lane ends with the same sums, in a fixed order.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < A; ++j) {
      nk[j] += __shfl_xor_sync(0xffffffffu, nk[j], o);
      sk[j] += __shfl_xor_sync(0xffffffffu, sk[j], o);
      qk[j] += __shfl_xor_sync(0xffffffffu, qk[j], o);
    }
    ll += __shfl_xor_sync(0xffffffffu, ll, o);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < A; ++j) {
      part[j] = first ? nk[j] : part[j] + nk[j];
      part[K + j] = first ? sk[j] : part[K + j] + sk[j];
      part[2 * K + j] = first ? qk[j] : part[2 * K + j] + qk[j];
    }
    part[3 * K] = first ? ll : part[3 * K] + ll;
  }
}

// accumulate<K, a> for a model of a (1..K) active components; a model
// with none has no statistics.
template <int K, int A = K>
__device__ __forceinline__ void accumulate_active(int a, const float* pts,
                                                  int cnt, const float* c2,
                                                  const float* mu,
                                                  const float* h2,
                                                  float* part, bool first) {
  if constexpr (A >= 1) {
    if (a == A) {
      accumulate<K, A>(pts, cnt, c2, mu, h2, part, first);
      return;
    }
    accumulate_active<K, A - 1>(a, pts, cnt, c2, mu, h2, part, first);
  }
}

// Grid: G * S clusters of CLUSTER blocks, cluster g * S + s running the
// models of subset s of group g; pts_len floats of staged points (at
// least tile, and 4 B ints of set-up scratch); at most mmax models a
// block.
// Blocks an SM the registers of gmm_em_kernel<K> must allow: MIN_BLOCKS up
// to 6 components; one above, where a model's 3K parameters and 3K + 1
// sums would not fit MIN_BLOCKS blocks' registers without spilling.
constexpr int min_blocks(int K) { return K <= 6 ? MIN_BLOCKS : 1; }

template <int K>
__global__ void __launch_bounds__(THREADS, min_blocks(K))
gmm_em_kernel(const float* __restrict__ z, const int* __restrict__ counts,
              int N, int B, int S, int tile, int pts_len, int mmax,
              const float* __restrict__ w0, const float* __restrict__ mu0,
              const float* __restrict__ var0,
              const unsigned char* __restrict__ mask, int n_iter, float reg,
              float* __restrict__ w_out, float* __restrict__ mu_out,
              float* __restrict__ var_out, float* __restrict__ ll_out) {
  constexpr int NST = Layout<K>::NST;
  // The block's model count, its group's valid points and its slice of
  // them: read from here where used, so that no register holds them
  // across the E-step's loop.
  __shared__ int s_nm, s_n, s_lo, s_len;
  const Layout<K> L{pts_len, mmax};
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int g = blockIdx.x / CLUSTER / S;
  const float* zg = z + static_cast<size_t>(g) * N;

  // Set-up: this block's models, their starts and their round-0 constants;
  // the block's slice of the group's valid points, staged when it fits.
  {
    const int rank = static_cast<int>(cluster.block_rank());
    const int sub = blockIdx.x / CLUSTER % S;
    const size_t mbase = static_cast<size_t>(g) * B;
    int* nact = reinterpret_cast<int*>(L.pts());
    for (int b = t; b < B; b += THREADS) {
      int a = 0;
      for (int k = 0; k < K; ++k) a += mask[(mbase + b) * K + k] != 0;
      nact[b] = a;
    }
    __syncthreads();
    if (t == 0) {
      int* subset = nact + B;
      gmm::assign_subsets(nact, B, S, mmax, subset + B, subset + B + S,
                          subset);
      int nm = 0;
      for (int b = 0; b < B; ++b) {
        if (subset[b] != sub) continue;
        L.model()[nm] = b;
        L.nact()[nm] = nact[b];
        ++nm;
      }
      s_nm = nm;
      const int n = min(counts[g], N);
      s_n = n;
      s_lo = static_cast<int>(static_cast<long long>(n) * rank / CLUSTER);
      s_len = static_cast<int>(static_cast<long long>(n) * (rank + 1) /
                               CLUSTER) - s_lo;
    }
    __syncthreads();
    const int nm = s_nm;
    float *w = L.comp(0), *mu = L.comp(1), *var = L.comp(2);
    for (int e = t; e < nm * K; e += THREADS) {
      const int mi = e / K, k = e % K;
      const size_t o = (mbase + L.model()[mi]) * K + k;
      w[e] = w0[o];
      mu[e] = mu0[o];
      var[e] = var0[o];
      L.pos()[e] = mask[o] != 0 ? 0 : -1;
    }
    for (int e = t; e < mmax * WARPS * NST; e += THREADS) L.part()[e] = 0.0f;
    __syncthreads();
    for (int mi = t; mi < nm; mi += THREADS) {
      int j = 0;
      for (int k = 0; k < K; ++k)
        if (L.pos()[mi * K + k] >= 0) L.pos()[mi * K + k] = j++;
    }
    __syncthreads();
    for (int e = t; e < nm * K; e += THREADS) {
      const int mi = e / K, j = L.pos()[e];
      if (j < 0) continue;
      gmm::component_constants(w[e], var[e], true, DeviceLog(),
                               &L.comp(4)[mi * K + j], &L.comp(6)[mi * K + j]);
      L.comp(5)[mi * K + j] = mu[e];
    }
    if (s_len <= tile)
      for (int i = t; i < s_len; i += THREADS)
        L.pts()[i] = __ldg(zg + s_lo + i);
  }
  __syncthreads();
  const int ntiles = (s_len + tile - 1) / tile;

  for (int it = 0;; ++it) {
    for (int ti = 0; ti < ntiles; ++ti) {
      const int first = ti * tile;
      const int cnt = min(tile, s_len - first);
      if (ntiles > 1) {
        __syncthreads();
        for (int i = t; i < cnt; i += THREADS)
          L.pts()[i] = __ldg(zg + s_lo + first + i);
        __syncthreads();
      }
      for (int mi = 0; mi < s_nm; ++mi)
        accumulate_active<K>(
            L.nact()[mi], L.pts(), cnt, L.comp(4) + mi * K,
            L.comp(5) + mi * K, L.comp(6) + mi * K,
            L.part() + (mi * WARPS + (threadIdx.x >> 5)) * NST, ti == 0);
    }
    __syncthreads();
    // The block's sums, in warp order.
    float* blk = L.blk(it & 1);
    for (int e = t; e < s_nm * NST; e += THREADS) {
      const int mi = e / NST, st = e % NST;
      const float* p = L.part() + mi * WARPS * NST + st;
      float v = p[0];
      for (int w = 1; w < WARPS; ++w) v = v + p[w * NST];
      blk[e] = v;
    }
    cluster.sync();
    // The cluster's sums, in rank order; every block gets the same bits.
    for (int e = t; e < s_nm * NST; e += THREADS) {
      float v = 0.0f;
      for (int r = 0; r < CLUSTER; ++r) {
        const float* peer = cluster.map_shared_rank(blk, r);
        v = r == 0 ? peer[e] : v + peer[e];
      }
      L.tot()[e] = v;
    }
    __syncthreads();
    if (it == n_iter) break;
    // The M-step, one thread per (model, component).
    float *w = L.comp(0), *mu = L.comp(1), *var = L.comp(2);
    float *wraw = L.comp(3), *c2 = L.comp(4), *cm = L.comp(5);
    float* h2 = L.comp(6);
    for (int e = t; e < s_nm * K; e += THREADS) {
      const int mi = e / K, j = L.pos()[e];
      const bool act = j >= 0;
      const float* tot = L.tot() + mi * NST;
      gmm::component_update(act ? tot[j] : 0.0f, act ? tot[K + j] : 0.0f,
                            act ? tot[2 * K + j] : 0.0f,
                            static_cast<float>(s_n), reg, act, &mu[e],
                            &var[e], &wraw[e]);
    }
    __syncthreads();
    for (int e = t; e < s_nm * K; e += THREADS) {
      const int mi = e / K, k = e % K, j = L.pos()[e];
      float we, mue = mu[e], vare = var[e];
      gmm::component_finish<K>(wraw + mi * K, k, j >= 0, &we, &mue, &vare);
      w[e] = we;
      mu[e] = mue;
      var[e] = vare;
      if (j >= 0) {
        gmm::component_constants(we, vare, true, DeviceLog(),
                                 &c2[mi * K + j], &h2[mi * K + j]);
        cm[mi * K + j] = mue;
      }
    }
    __syncthreads();
  }

  if (cluster.block_rank() == 0) {
    const float *w = L.comp(0), *mu = L.comp(1), *var = L.comp(2);
    const size_t mbase = static_cast<size_t>(g) * B;
    for (int e = t; e < s_nm * K; e += THREADS) {
      const size_t o = (mbase + L.model()[e / K]) * K + e % K;
      w_out[o] = w[e];
      mu_out[o] = mu[e];
      var_out[o] = var[e];
    }
    for (int mi = t; mi < s_nm; mi += THREADS)
      ll_out[mbase + L.model()[mi]] = L.tot()[mi * NST + 3 * K];
  }
  // Peers may still read this block's sums.
  cluster.sync();
}

// The launch's shape: subsets a group, models a block at most, points a
// staged tile and the points' buffer, dynamic shared memory, and what the
// card holds of it at once.
struct Geometry {
  int subsets, mmax, tile, pts_len, smem_bytes, active_clusters,
      blocks_per_sm;
};

cudaLaunchAttribute cluster_attribute() {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// Clusters the card holds at once, and blocks an SM, with smem bytes of
// dynamic shared memory a block.
template <int K>
cudaError_t occupancy(size_t smem, int* clusters, int* per_sm) {
  const auto kernel = gmm_em_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && CLUSTER > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr = cluster_attribute();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       THREADS, smem);
}

int models_cap(int B, int S) { return std::min(B, (B + S - 1) / S + 1); }

// As many subsets of each group's models as the card holds clusters at
// once (one wave), and more where a block's share of shared memory would
// not fit: the models a block may hold set its shared memory, which sets
// how many clusters fit, so the choice is refined twice.
template <int K>
cudaError_t geometry(int G, int N, int B, Geometry* geo) {
  const int tile = std::max(1, std::min(TILE_MAX, (N + CLUSTER - 1) /
                                                      CLUSTER));
  const int pts_len = std::max(tile, 4 * B);
  int S = B, clusters = 0, per_sm = 0;
  for (int pass = 0; pass < 3; ++pass) {
    while (S < B && Layout<K>::bytes(pts_len, models_cap(B, S)) > SMEM_MAX)
      S = std::min(B, 2 * S);
    const cudaError_t err = occupancy<K>(
        Layout<K>::bytes(pts_len, models_cap(B, S)), &clusters, &per_sm);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    if (pass < 2) S = std::min(B, std::max(1, clusters / G));
  }
  geo->subsets = S;
  geo->mmax = models_cap(B, S);
  geo->tile = tile;
  geo->pts_len = pts_len;
  geo->smem_bytes = static_cast<int>(Layout<K>::bytes(pts_len, geo->mmax));
  geo->active_clusters = clusters;
  geo->blocks_per_sm = per_sm;
  return cudaSuccess;
}

template <int K>
int launch(const float* z, const int* counts, int G, int N, int B,
           const float* w0, const float* mu0, const float* var0,
           const unsigned char* mask, int n_iter, float reg, float* w,
           float* mu, float* var, float* ll, cudaStream_t stream) {
  Geometry geo;
  cudaError_t err = geometry<K>(G, N, B, &geo);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr = cluster_attribute();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * geo.subsets * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = geo.smem_bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gmm_em_kernel<K>, z, counts, N, B,
                           geo.subsets, geo.tile, geo.pts_len, geo.mmax, w0,
                           mu0, var0, mask, n_iter, reg, w, mu, var, ll);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int geometry_of(int G, int N, int B, int* out) {
  Geometry geo;
  const cudaError_t err = geometry<K>(G, N, B, &geo);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[] = {geo.subsets, CLUSTER, WARPS, geo.tile,
                      geo.smem_bytes, geo.active_clusters, geo.blocks_per_sm,
                      geo.mmax, G * geo.subsets * CLUSTER};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace

// z: (G, N) float32 standardised data, counts: (G,) int32 valid points of
// each group (a prefix of its row); w0, mu0, var0: (G, B, K) float32
// starts; mask: (G, B, K) bool (one byte each), the active components.
// Outputs: w, mu, var (G, B, K) and ll (G, B) float32. All contiguous on
// the current device; 1 <= K <= gmm::KMAX, B <= 4096. Returns a CUDA
// error code (0 on success).
extern "C" int gmm_em_launch(const float* z, const int* counts, int G, int N,
                             int B, int K, const float* w0, const float* mu0,
                             const float* var0, const unsigned char* mask,
                             int n_iter, float reg, float* w, float* mu,
                             float* var, float* ll, void* stream) {
  if (G == 0 || B == 0) return 0;
  if (B > BMAX) return static_cast<int>(cudaErrorInvalidValue);
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

// The launch's geometry for (G, N, B, K), as gmm_em_launch would choose it:
// out[0..8] = subsets a group, blocks a cluster, warps a block, points a
// staged tile, dynamic shared memory bytes, clusters the card holds at
// once, blocks an SM holds, models a block at most, blocks in the grid.
// Returns a CUDA error code (0 on success).
extern "C" int gmm_em_geometry(int G, int N, int B, int K, int* out) {
  if (G < 1 || B < 1 || B > BMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (K) {
    case 1: return geometry_of<1>(G, N, B, out);
    case 2: return geometry_of<2>(G, N, B, out);
    case 3: return geometry_of<3>(G, N, B, out);
    case 4: return geometry_of<4>(G, N, B, out);
    case 5: return geometry_of<5>(G, N, B, out);
    case 6: return geometry_of<6>(G, N, B, out);
    case 7: return geometry_of<7>(G, N, B, out);
    case 8: return geometry_of<8>(G, N, B, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
