// Band -> bidiagonal bulge chase past b = 256 on thread-block clusters:
// the sequential schedule on one cluster, and the wavefront schedule with
// a cluster a work unit.  Every pair is chase_cluster.cuh's
// chase_pair_cluster, the wide pair of chase_pair.cuh split over the
// cluster's CTAs with every entry's operations in the wide pair's order,
// so (d, e) and the records are the L2 kernel's (band_chase.cu) bit for
// bit.
//
// svdt_band_chase_cluster and _cluster_rec stand, past b = 256, for the
// TPU kernels the L2 kernel stands for there:
//   svdsolver_tpu/ops/pallas/band_chase.py        _chase_kernel (K3),
//       _chase_kernel_rec (K6);
//   svdsolver_tpu/ops/pallas/band_chase_stream.py _stream_chase_kernel
//       (K5, and K8 with rec=True) where the main paths' predicate picks
//       the sequential chase.
// svdt_band_chase_wave_cluster and _cluster_rec stand, past b = 256, for
//   svdsolver_tpu/ops/pallas/band_chase_wave.py  _wave_chase_kernel (K4),
//       _wave_chase_rec_kernel (K7);
//   svdsolver_tpu/ops/pallas/band_chase.py       _wavefront_kernel (K13).
// Their plain versions are models/two_stage's band_to_bidiagonal,
// band_to_bidiagonal_accum and band_to_bidiagonal_wavefront; the L2 kernel
// and the wavefront's L2 tick stay as the bitwise oracles and as the route
// past the plan (ops/cuda/band_chase.wide_chase_plan).
//
// Kernel 1 (band_chase_cluster_kernel): one cluster of C CTAs of 512
// threads walks band_chase_kernel's schedule: sweep i's head pair, then
// its nc_of(i, n, b) chase pairs, each chase_pair_cluster; then the
// cluster gathers d and e.  No grid barrier: the pairs are ordered by the
// pair's two cluster barriers.  Recording: CTA 0 stores each reflector
// into the slot the L2 kernel fills ((n-1, s_max, b) layout, Records).
//
// Kernel 2 (wave_cluster_kernel): wave_chase_kernel's schedule (sweep i
// runs slot s at tick 3 i + s; unit 0 the head pair, units 1..L the
// lanes) with cluster g of G running units g, g + G, ...; a tick ends
// with one barrier over every CTA of the grid (grid_sync.cuh).  That
// barrier needs every cluster co-resident: G is at most
// cudaOccupancyMaxActiveClusters, and the launch carries the cooperative
// attribute beside the cluster dimension, which the runtime takes
// together (CUDA 12.8 on the H100).
//
// What bounds them on the H100: a pair's window through C SMs' L2 rate
// (2b^2/C floats in and out on each side a CTA), its two reflectors (a
// block reduction each, every CTA alike) and two cluster barriers, one
// pair after another (kernel 1) or a tick's slowest pair plus a grid
// barrier (kernel 2).  FLOPs and device memory bandwidth are far from
// bounding either.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chase_cluster.cuh"
#include "grid_sync.cuh"

#ifdef SVDT_CLUSTER_STAMPS
// The timing build's stamp buffer and the pairs it stamps
// (tools/chase_cluster_split.py).
extern "C" int svdt_chase_cluster_stamps(long long* p, int first, int count) {
  cudaError_t err = cudaMemcpyToSymbol(g_cluster_stamps, &p, sizeof(p));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_stamp_first, &first, sizeof(int));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_stamp_count, &count, sizeof(int));
  return (int)err;
}
#endif

namespace {

using namespace svdt;
namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;

// The CTA's share of the pair's state: v, the factors and the stage in
// dynamic shared memory, the block reflector's partials and the cluster
// barrier's mbarriers in static.
struct CtaState {
  ClusterPair cp;
  ClusterBarrier cb;
};

__device__ __forceinline__ CtaState cta_state(float* A, int n, int b, WidePlan p,
                                              float* dyn, float* part,
                                              unsigned long long* bars) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  CtaState st;
  st.cp = {A, n, dyn, dyn + ((b + 31) & ~31), dyn + wide_head_floats(b, p.cols), part, p,
           C, (int)cluster.block_rank()};
  st.cb = {bars, C, 0u, 0u, 0u};
  st.cb.init();
  cluster.sync();  // every CTA's barriers initialised before any remote arrival
  return st;
}

template <bool Rec>
__global__ void __launch_bounds__(kThreads, 1)
band_chase_cluster_kernel(float* __restrict__ A, float* __restrict__ d,
                          float* __restrict__ e, int n, int b, WidePlan p, Records rec) {
  extern __shared__ __align__(128) float dyn[];
  __shared__ float part[kWarps];
  __shared__ unsigned long long bars[4];
  CtaState st = cta_state(A, n, b, p, dyn, part, bars);
  const Slot none = {nullptr, nullptr};
  for (int i = 0; i < n - 1; ++i) {
    // head pair: slot 0 (left reflector rows [i+1, i+1+b))
    chase_pair_cluster<Rec>(st.cp, st.cb, b, i, i + 1, b + 1, 1,
                            Rec ? rec.right(i, 0, b) : none,
                            Rec ? rec.left(i, 0, b) : none);
    const int nc = nc_of(i, n, b);
    for (int k = 0; k < nc; ++k) {  // chase pair k: slot k + 1
      const int r = i + 1 + k * b;
      chase_pair_cluster<Rec>(st.cp, st.cb, b, r, r + b, 2 * b, b,
                              Rec ? rec.right(i, k + 1, b) : none,
                              Rec ? rec.left(i, k + 1, b) : none);
    }
  }
  const int C = st.cp.C;
  for (int k = st.cp.rank * kThreads + threadIdx.x; k < n; k += C * kThreads) {
    d[k] = __ldcg(A + (size_t)k * n + k);
    if (k + 1 < n) e[k] = __ldcg(A + (size_t)k * n + k + 1);
  }
  cg::this_cluster().sync();  // no CTA leaves while another may arrive on its barriers
}

template <bool Rec>
__global__ void __launch_bounds__(kThreads, 1)
wave_cluster_kernel(float* __restrict__ A, float* __restrict__ d, float* __restrict__ e,
                    int n, int b, int L, int T, unsigned* ctr, WidePlan p, Records rec) {
  extern __shared__ __align__(128) float dyn[];
  __shared__ float part[kWarps];
  __shared__ unsigned long long bars[4];
  CtaState st = cta_state(A, n, b, p, dyn, part, bars);
  const Slot none = {nullptr, nullptr};
  const int C = st.cp.C;
  const int G = (int)gridDim.x / C, g = (int)blockIdx.x / C;
  unsigned target = 0;
  for (int t = 0; t < T; ++t) {
    const int q = t >= 1 ? (t - 1) / 3 : -1;  // newest sweep past its head
    for (int u = g; u <= L; u += G) {
      if (u == 0) {  // the head pair of sweep t / 3
        const int i = t / 3;
        if (t % 3 != 0 || i > n - 2) continue;
        chase_pair_cluster<Rec>(st.cp, st.cb, b, i, i + 1, b + 1, 1,
                                Rec ? rec.right(i, 0, b) : none,
                                Rec ? rec.left(i, 0, b) : none);
        continue;
      }
      const int i = q - (u - 1);
      const int s = t - 3 * i;
      if (i < 0 || i > n - 2 || s > nc_of(i, n, b)) continue;
      const int r = i + 1 + (s - 1) * b;
      chase_pair_cluster<Rec>(st.cp, st.cb, b, r, r + b, 2 * b, b,
                              Rec ? rec.right(i, s, b) : none,
                              Rec ? rec.left(i, s, b) : none);
    }
    target += gridDim.x;
    grid_sync(ctr, target);
  }
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < n; k += gridDim.x * kThreads) {
    d[k] = __ldcg(A + (size_t)k * n + k);
    if (k + 1 < n) e[k] = __ldcg(A + (size_t)k * n + k + 1);
  }
  cg::this_cluster().sync();  // no CTA leaves while another may arrive on its barriers
}

// The plan's checks: C CTAs hold the 2b columns (at most kThreads a CTA),
// a chunk holds one row on either side and fits the stage, and v, the
// factors and the stage fit `smem` bytes.
bool plan_ok(int n, int b, int C, WidePlan p, int smem) {
  if (n < 2 || b <= kMaxBand || b > n || C < 1 || C > kMaxCluster) return false;
  if (p.cols < 1 || p.cols > kThreads || (long long)p.cols * C < 2LL * b) return false;
  if (p.rchunk < 1 || p.lchunk < 1) return false;
  if ((long long)p.rchunk * stage_ld(b) > p.stage ||
      (long long)p.lchunk * stage_ld(p.cols) > p.stage)
    return false;
  return 4LL * (wide_head_floats(b, p.cols) + (long long)p.stage) <= smem;
}

template <class Kernel>
cudaError_t configure(Kernel kernel, int C, int G, int smem, cudaStream_t s,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, bool coop) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *cfg = {};
  cfg->gridDim = dim3(G * C);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg->attrs = attr;
  cfg->numAttrs = coop ? 2 : 1;
  return err;
}

template <class Kernel>
int clusters_of(Kernel kernel, int C, int smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = configure(kernel, C, 1, smem, 0, &cfg, attr, false);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return (int)err;
}

template <bool Rec>
int launch_seq(float* A, float* d, float* e, int n, int b, Records rec, int C, WidePlan p,
               int smem, void* stream) {
  if (!plan_ok(n, b, C, p, smem)) return (int)cudaErrorInvalidValue;
  auto kernel = band_chase_cluster_kernel<Rec>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = configure(kernel, C, 1, smem, (cudaStream_t)stream, &cfg, attr, false);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, A, d, e, n, b, p, rec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool Rec>
int launch_wave(float* A, float* d, float* e, int n, int b, Records rec, unsigned* ctr,
                int C, WidePlan p, int smem, int max_clusters, int* clusters, void* stream) {
  if (!plan_ok(n, b, C, p, smem)) return (int)cudaErrorInvalidValue;
  auto kernel = wave_cluster_kernel<Rec>;
  const int S = nc_of(0, n, b);  // slots past the head
  int L = (S + 2) / 3;
  int T = 3 * (n - 2) + S + 1;
  int fit = 0;
  int err = clusters_of(kernel, C, smem, &fit);
  if (err != 0) return err;
  int G = L + 1 < fit ? L + 1 : fit;
  if (max_clusters > 0 && max_clusters < G) G = max_clusters;
  if (G < 1) return (int)cudaErrorInvalidConfiguration;
  *clusters = G;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t e2 = configure(kernel, C, G, smem, (cudaStream_t)stream, &cfg, attr, true);
  if (e2 != cudaSuccess) return (int)e2;
  e2 = cudaLaunchKernelEx(&cfg, kernel, A, d, e, n, b, L, T, ctr, p, rec);
  if (e2 != cudaSuccess) return (int)e2;
  return (int)cudaGetLastError();
}

}  // namespace

// The sequential chase on one cluster of C CTAs on `stream`, overwriting
// A (n x n, row-major, upper band b > 256): (d, e) as svdt_band_chase's.
// The plan (cols, rchunk, lchunk, stage; smem dynamic bytes a CTA) is
// ops/cuda/band_chase.wide_chase_plan's.  Returns the launch's
// cudaError_t.
extern "C" int svdt_band_chase_cluster(float* A, float* d, float* e, int n, int b, int C,
                                       int cols, int rchunk, int lchunk, int stage, int smem,
                                       void* stream) {
  return launch_seq<false>(A, d, e, n, b, {nullptr, nullptr, nullptr, nullptr, 0}, C,
                           {cols, rchunk, lchunk, stage}, smem, stream);
}

// As svdt_band_chase_cluster, and writes every reflector into the
// zero-initialised records VL, VR (n-1, s_max, b) and TL, TR (n-1, s_max),
// the slots and values of svdt_band_chase_rec.
extern "C" int svdt_band_chase_cluster_rec(float* A, float* d, float* e, int n, int b,
                                           float* VL, float* TL, float* VR, float* TR,
                                           int s_max, int C, int cols, int rchunk,
                                           int lchunk, int stage, int smem, void* stream) {
  return launch_seq<true>(A, d, e, n, b, {VL, TL, VR, TR, s_max}, C,
                          {cols, rchunk, lchunk, stage}, smem, stream);
}

// The wavefront chase with a cluster of C CTAs a work unit on `stream`:
// (d, e) as svdt_band_chase's.  ctr is one zeroed counter for the grid
// barrier; at most max_clusters clusters (0: as many as are co-resident,
// at most one a unit); the clusters launched go to *clusters.  Returns the
// launch's cudaError_t.
extern "C" int svdt_band_chase_wave_cluster(float* A, float* d, float* e, int n, int b,
                                            unsigned* ctr, int C, int cols, int rchunk,
                                            int lchunk, int stage, int smem, int max_clusters,
                                            int* clusters, void* stream) {
  return launch_wave<false>(A, d, e, n, b, {nullptr, nullptr, nullptr, nullptr, 0}, ctr, C,
                            {cols, rchunk, lchunk, stage}, smem, max_clusters, clusters,
                            stream);
}

// As svdt_band_chase_wave_cluster, recording every reflector as
// svdt_band_chase_cluster_rec does.
extern "C" int svdt_band_chase_wave_cluster_rec(float* A, float* d, float* e, int n, int b,
                                                float* VL, float* TL, float* VR, float* TR,
                                                int s_max, unsigned* ctr, int C, int cols,
                                                int rchunk, int lchunk, int stage, int smem,
                                                int max_clusters, int* clusters,
                                                void* stream) {
  return launch_wave<true>(A, d, e, n, b, {VL, TL, VR, TR, s_max}, ctr, C,
                           {cols, rchunk, lchunk, stage}, smem, max_clusters, clusters,
                           stream);
}

// Clusters of C CTAs with `smem` dynamic bytes each that the card holds at
// once (cudaOccupancyMaxActiveClusters) into *clusters: kernel 1 (wave 0)
// or kernel 2 (wave 1), recording or not.
extern "C" int svdt_band_chase_cluster_fit(int C, int smem, int wave, int rec,
                                           int* clusters) {
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  if (wave)
    return rec ? clusters_of(wave_cluster_kernel<true>, C, smem, clusters)
               : clusters_of(wave_cluster_kernel<false>, C, smem, clusters);
  return rec ? clusters_of(band_chase_cluster_kernel<true>, C, smem, clusters)
             : clusters_of(band_chase_cluster_kernel<false>, C, smem, clusters);
}
