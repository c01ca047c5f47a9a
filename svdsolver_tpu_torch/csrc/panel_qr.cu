// Compact-WY Householder QR of one transposed panel, in one cluster launch.
//
// Replaces: svdsolver_tpu/ops/pallas/panel_qr.py, _panel_kernel (launched by
// _panel_qr_pallas).  Same contract: the panel arrives transposed, Pt (b, m)
// row-major, so panel column j is row j with its pivot at column r_off + j.
// Outputs: Rt (b, m), the factored panel with exact zeros beyond each pivot
// and beta at it; Vt (b, m), the reflectors as rows (zero before the pivot,
// one at it); and Tt (b, b), the compact-WY factor transposed (T^T), so that
// Q = I - V T V^T with V = Vt^T, T = Tt^T.  A pivot at or past m gives the
// identity reflector (tau = 0, v = 0, a zero T row).
//
// What bounds it on the H100: the b columns are strictly sequential, and each
// one needs two sums over the whole panel (the column's norm, then one dot
// product a row) before the next can start.  So per column the latency of
// two reductions across SMs bounds it, not FLOPs (b^2 m) or bytes (3 b m).
//
// Design: a thread-block cluster of C <= 16 CTAs (cudaLaunchKernelEx with a
// cluster dimension; non-portable sizes above 8).  The m axis is cut into C
// slabs of W columns; CTA r loads columns [r W, r W + W) of every row once
// (16-byte loads where aligned) into dynamic shared memory and keeps them
// there until it writes Rt and Vt once at the end.  R and V share the slab,
// packed as LAPACK packs them: past its pivot a finished row holds v, so the
// products u = Rt v (rows i > j) and w = Vt v (finished rows i < j) are one
// dot product over the packed rows, sum_{k >= p} slab[i][k] v[k].  Column j:
//   1. each CTA stores its partial |x_tail|^2 of row j (and the owner the
//      pivot) into slot `rank` of every CTA's shared memory (distributed
//      shared memory stores); cluster.sync; every warp sums the C local
//      slots in one fixed tree order, so every CTA computes the same
//      (beta, tau) bit for bit;
//   2. each CTA builds v on its own columns (row j of the slab becomes beta
//      at the pivot and v past it);
//   3. each CTA stores its b partial dots into every CTA's shared memory;
//      cluster.sync; row i's C partials are summed locally in rank order;
//   4. each CTA applies the rank-1 update to its columns of rows > j, and
//      the T row Tt[j] = -tau w^T Tt[:j] + tau e_j to its share of T's
//      columns (b / C of them, kept in shared memory).
// Partials are pushed, not pulled: a remote store does not wait, so the
// only cross-SM latency a column pays is its two cluster barriers (no
// grid-wide one).  The norm slots are double-buffered by column parity, so
// the next column's partial never overwrites one a slower CTA still reads.
// The dot and update passes map thread (row i, group g) to columns g, g + G,
// ... of row i, G lanes a row;
// the slab's row stride is = G (mod 32), so the 32 / G rows of a warp fall
// on distinct banks.  Identity reflectors (tau == 0, decided alike on every
// CTA) skip steps 3 and 4.
//
// Large panels (the large-panel route): at b = 128 a slab holds about 424
// columns in 227 KB, so a panel with m above ~6,800 (the first Stage I
// segment at n = 7680, 3.93 MB) does not fit 16 CTAs.  Each CTA then keeps
// the columns past its shared-memory capacity in device memory: in its own
// columns of the output Rt, which no other CTA touches, so no cross-CTA
// visibility is needed (the kernel's Spill instantiation).  The host plan
// (ops/cuda/panel_qr.cluster_plan) puts no cap on the device-memory share:
// at m = 23,040 a CTA keeps 392 of its 1,440 columns in shared memory.
// Nothing here assumes a cap: device-memory indices are size_t, the float4
// load lands a whole quad on one side of ws (ws, W, m multiples of 4), and
// a spilled column is read and written by this CTA only, ordered by the
// same __syncthreads and cluster barriers as the shared-memory ones.
//
// Wide panels: past b = 256 the host blocks the panel (ops/cuda/panel_qr.py,
// panel_qr_blocked): sub-panels of 64 rows, each one launch of this kernel
// at its narrow plan (T^T into its diagonal block of the whole T, row
// stride ldt), and the products between them on panel_gemm below.  So this
// kernel takes b <= 256: 4 lanes a row or more, T in shared memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;

// The cluster plan of ops/cuda/panel_qr.cluster_plan.
struct Plan {
  int W;    // columns a CTA
  int ws;   // of them in shared memory (ws == W unless Spill)
  int ld;   // slab row stride in shared memory, = G (mod 32)
  int tc;   // T columns a CTA
  int tld;  // their row stride in shared memory
  int G;    // lanes a row in the dot and update passes (power of two)
  int vec;  // Pt rows 16-byte aligned: load with float4
  int ldt;  // row stride of the output Tt (b, or the whole T's of a blocked panel)
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// This CTA's columns of the panel: [0, ws) in shared memory, [ws, kn) in
// device memory at gm (row stride gld; Spill only).
template <bool Spill>
struct Slab {
  float* sm;
  int ld;
  int ws;
  float* gm;
  int gld;
  __device__ float& at(int i, int k) const {
    if (!Spill || k < ws) return sm[i * ld + k];
    return gm[(size_t)i * gld + k];
  }
};

// Warp-level: store this CTA's partial |x|^2 of row i past pivot p into
// slot sg[rank] of every CTA of the cluster, and the pivot into sg[C] where
// this CTA holds it.
template <bool Spill>
__device__ void publish_norm(cg::cluster_group& cluster, const Slab<Spill>& s,
                             int i, int p, int cbase, int kn, float* sg) {
  const int lane = threadIdx.x & 31;
  const int C = (int)cluster.num_blocks();
  float part = 0.f;
  for (int k = max(0, p + 1 - cbase) + lane; k < kn; k += 32) {
    const float x = s.at(i, k);
    part += x * x;
  }
  part = warp_sum(part);
  const bool owner = p >= cbase && p < cbase + kn;
  const float pivot = owner ? s.at(i, p - cbase) : 0.f;
  if (lane < C) {
    float* dst = cluster.map_shared_rank(sg, lane);
    dst[cluster.block_rank()] = part;
    if (owner) dst[C] = pivot;
  }
}

// Row i's dot from the C partials in this CTA's shared memory, rank order.
__device__ __forceinline__ float dot_total(const float* recv, int C, int b,
                                           int i) {
  float t = 0.f;
  for (int r = 0; r < C; ++r) t += recv[r * b + i];
  return t;
}

// This CTA's T columns in shared memory (row stride tld).
struct TCols {
  float* p;
  int ld;
  __device__ float& at(int i, int cl) const { return p[(size_t)i * ld + cl]; }
};

template <bool Spill>
__global__ void __launch_bounds__(kThreads, 1)
panel_qr_cluster(const float* __restrict__ Pt, float* __restrict__ Rt,
                 float* __restrict__ Vt, float* __restrict__ Tt, int b, int m,
                 int r_off, Plan pl) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);  // b x ld
  float* v = slab + (size_t)b * pl.ld;            // W: v of the current column
  float* tl = v + pl.W;                           // b x tld: this CTA's T columns
  float* sig = tl + (size_t)b * pl.tld;           // 2 x (C norm partials, pivot)
  float* recv = sig + 2 * (kMaxCluster + 1);      // C x b: partial dots by rank

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = pl.G;
  const int RW = 32 / G;          // rows a warp holds at once
  const int RS = kThreads / G;    // rows a pass
  const int ri = lane / G;
  const int g = lane - ri * G;
  const int cbase = rank * pl.W;
  const int kn = max(0, min(pl.W, m - cbase));
  const int c0 = rank * pl.tc;
  const int tcn = max(0, min(pl.tc, b - c0));
  const Slab<Spill> s = {slab, pl.ld, Spill ? pl.ws : pl.W, Rt + cbase, m};
  const TCols tcol = {tl, pl.tld};

  // load the slab once
  if (pl.vec) {
    const int q = kn >> 2;  // kn % 4 == 0: W and m are multiples of 4
    for (int idx = tid; idx < b * q; idx += kThreads) {
      const int i = idx / q;
      const int k = 4 * (idx - i * q);
      const float4 x =
          *reinterpret_cast<const float4*>(Pt + (size_t)i * m + cbase + k);
      *reinterpret_cast<float4*>(&s.at(i, k)) = x;  // ws % 4 == 0: no straddle
    }
  } else {
    for (int idx = tid; idx < b * kn; idx += kThreads) {
      const int i = idx / kn;
      const int k = idx - i * kn;
      s.at(i, k) = Pt[(size_t)i * m + cbase + k];
    }
  }
  for (int idx = tid; idx < b * pl.tld; idx += kThreads) tl[idx] = 0.f;
  __syncthreads();

  auto owner = [&](int i) { return (i % RS) / RW; };  // warp of row i's passes
  const int jn = max(0, min(b, m - r_off));  // columns with a pivot in the panel
  // no CTA stores into another's shared memory before that one has started
  cluster.sync();
  if (jn > 0 && warp == owner(0))
    publish_norm(cluster, s, 0, r_off, cbase, kn, sig);

  for (int j = 0; j < jn; ++j) {
    const int p = r_off + j;
    const float* sg = sig + (kMaxCluster + 1) * (j & 1);
    cluster.sync();  // every CTA's norm partial of row j has arrived
    // the reflector, the same on every CTA: the C partials in one tree order
    const float sigma2 = warp_sum(lane < C ? sg[lane] : 0.f);
    const float pivot = sg[C];
    const float norm = sqrtf(pivot * pivot + sigma2);
    const float beta = pivot >= 0.f ? -norm : norm;
    const bool trivial = sigma2 == 0.f;
    const float denom = trivial ? 1.f : pivot - beta;
    const float tau = trivial ? 0.f : (beta - pivot) / (beta == 0.f ? 1.f : beta);

    // v on this CTA's columns from the first G-aligned one at or below the
    // pivot (zero before it); row j becomes beta at the pivot and v past it
    const int kp = p - cbase;
    const int k0 = kp <= 0 ? 0 : (kp & ~(G - 1));
    for (int k = k0 + tid; k < kn; k += kThreads) {
      float vk = 0.f;
      if (k == kp) {
        vk = 1.f;
        s.at(j, k) = trivial ? pivot : beta;
      } else if (k > kp) {
        vk = s.at(j, k) / denom;
        s.at(j, k) = vk;
      }
      v[k] = vk;
    }
    if (tau != 0.f) {  // cluster-uniform
      __syncthreads();  // v and row j
      // partial dots: rows i < j give (Vt v)_i, rows i > j give (Rt v)_i
      for (int i0 = warp * RW; i0 < b; i0 += RS) {
        const int i = i0 + ri;
        float acc = 0.f;
        if (i < b)
          for (int k = k0 + g; k < kn; k += G) acc += s.at(i, k) * v[k];
        for (int o = G >> 1; o > 0; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        // every lane of the row holds the sum: lane g stores it to ranks
        // g, g + G, ...
        if (i < b)
          for (int r = g; r < C; r += G)
            cluster.map_shared_rank(recv, r)[rank * b + i] = acc;
      }
      cluster.sync();  // every CTA's partial dots have arrived
      // rank-1 update of rows > j on this CTA's columns
      for (int i0 = warp * RW; i0 < b; i0 += RS) {
        const int i = i0 + ri;
        if (i <= j || i >= b) continue;
        const float f = tau * dot_total(recv, C, b, i);
        for (int k = k0 + g; k < kn; k += G) {
          float& x = s.at(i, k);
          x = x - f * v[k];
        }
      }
    }
    // row j + 1 was updated by its own lanes: its norm partial needs no
    // barrier beyond the warp's, and goes out before the T row, which the
    // next column does not wait for
    if (j + 1 < jn && warp == owner(j + 1)) {
      __syncwarp();
      publish_norm(cluster, s, j + 1, p + 1, cbase, kn,
                   sig + (kMaxCluster + 1) * ((j + 1) & 1));
    }
    if (tau != 0.f) {
      // larft, transposed, on this CTA's T columns:
      // Tt[j, c] = -tau * w^T Tt[:j, c] + tau [c == j]
      for (int cl = warp; cl < tcn; cl += kWarps) {
        float acc = 0.f;
        for (int i = lane; i < j; i += 32)
          acc += dot_total(recv, C, b, i) * tcol.at(i, cl);
        acc = warp_sum(acc);
        if (lane == 0)
          tcol.at(j, cl) = -tau * acc + (c0 + cl == j ? tau : 0.f);
      }
    }
  }
  __syncthreads();

  // R with exact zeros past each pivot; V with 1 at it, v past it
  for (int idx = tid; idx < b * kn; idx += kThreads) {
    const int i = idx / kn;
    const int k = idx - i * kn;
    const int kg = cbase + k;
    const int pi = r_off + i;
    const float x = s.at(i, k);
    Rt[(size_t)i * m + kg] = kg <= pi ? x : 0.f;
    Vt[(size_t)i * m + kg] = kg < pi ? 0.f : (kg == pi ? 1.f : x);
  }
  for (int idx = tid; idx < b * tcn; idx += kThreads) {
    const int i = idx / tcn;
    const int cl = idx - i * tcn;
    Tt[(size_t)i * pl.ldt + c0 + cl] = tl[i * pl.tld + cl];
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

template <bool Spill>
cudaError_t configure(int C, int smem, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, cudaStream_t stream) {
  auto kernel = panel_qr_cluster<Spill>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *cfg = {};
  cfg->gridDim = dim3(C);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

template <bool Spill>
int launch(const float* Pt, float* Rt, float* Vt, float* Tt, int b, int m,
           int r_off, int C, Plan pl, int smem, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<Spill>(C, smem, &cfg, &attr, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, panel_qr_cluster<Spill>, Pt, Rt, Vt, Tt, b,
                           m, r_off, pl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool Spill>
int clusters_of(int C, int smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<Spill>(C, smem, &cfg, &attr, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters, panel_qr_cluster<Spill>, &cfg);
  return (int)err;
}

// ---- The blocked panel's products (b > 256) ----
//
// Past b = 256 the panel is factored in sub-panels of nb rows of Pt, each
// by the kernel above (ops/cuda/panel_qr.py: panel_qr_blocked); what the
// TPU kernel's column loop does between them becomes products of tall,
// thin operands, each one launch of panel_gemm:
//   the Gram  G = [Vt_{0:k}; Pt_rest] Vt_k^T over the columns from the
//             sub-panel's first pivot, split over K; panel_sum adds the
//             splits in order;
//   update    Pt_rest -= ((G_rest) T_k) Vt_k, T_k = Tt_kk^T;
//   merge     Tt_{k,0:k} = -Tt_kk (G_{0:k}^T Tt_{0:k,0:k}).
// Plain fp32 FMA tiles (no tensor cores, no TF32): C_z[i][j] = alpha
// sum_{k in split z} A(i, k) B(k, j) (+ beta C[i][j] where beta != 0), an
// operand's element at p + i si + k sk; A's rows from a_split on come from
// a2 (the Gram's stack of finished V rows over the panel's rows still to
// factor).  64 x 64 tiles of C, k 16 at a time through shared memory, the
// next 16 loaded into registers under this step's products, 4 x 4 a
// thread; the tile loads follow whichever stride is 1.  Every launch gives
// the same bits.  What bounds them: the Gram reads the panel's rows once
// (bytes); the update is a rank-nb product (operations, 2 r (m - p0) nb);
// a few us each beside a sub-panel's ~0.3 ms.
constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kGemmThreads = 256;
constexpr int kLoads = kTile * kDepth / kGemmThreads;  // elements a thread, a tile

struct GemmArgs {
  const float* a;
  const float* a2;
  long long a_si, a_sk;
  int a_split;
  const float* b;
  long long b_sk, b_sj;
  float* c;
  long long c_si, c_sj, c_sz;
  int M, N, K, chunk;
  float alpha, beta;
};

// Element u of this thread's share of a 64 x 16 tile: (row, k) with the
// unit stride on consecutive threads.
__device__ __forceinline__ void tile_slot(int e, bool k_fast, int& r, int& k) {
  if (k_fast) {
    r = e / kDepth;
    k = e % kDepth;
  } else {
    k = e / kTile;
    r = e % kTile;
  }
}

__global__ void __launch_bounds__(kGemmThreads)
panel_gemm(GemmArgs g) {
  __shared__ float As[kDepth][kTile + 4];
  __shared__ __align__(16) float Bs[kDepth][kTile + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int kb = blockIdx.z * g.chunk;
  const int ke = min(g.K, kb + g.chunk);
  const bool a_kfast = g.a_sk == 1, b_kfast = g.b_sj != 1;
  float ra[kLoads], rb[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      int r, kk;
      tile_slot(tid + u * kGemmThreads, a_kfast, r, kk);
      const int i = i0 + r, k = k0 + kk;
      ra[u] = i < g.M && k < ke
                  ? (i < g.a_split ? g.a : g.a2)[i * g.a_si + k * g.a_sk]
                  : 0.f;
      tile_slot(tid + u * kGemmThreads, b_kfast, r, kk);
      const int j = j0 + r;
      rb[u] = j < g.N && k0 + kk < ke ? g.b[(k0 + kk) * g.b_sk + j * g.b_sj] : 0.f;
    }
  };
  float acc[4][4] = {};
  if (kb < ke) load(kb);
  for (int k0 = kb; k0 < ke; k0 += kDepth) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      int r, kk;
      tile_slot(tid + u * kGemmThreads, a_kfast, r, kk);
      As[kk][r] = ra[u];
      tile_slot(tid + u * kGemmThreads, b_kfast, r, kk);
      Bs[kk][r] = rb[u];
    }
    __syncthreads();
    if (k0 + kDepth < ke) load(k0 + kDepth);  // in flight under the products
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty * 4 + r];
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], bb[q], acc[r][q]);
    }
    __syncthreads();
  }
  float* cz = g.c + blockIdx.z * g.c_sz;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= g.M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (j >= g.N) continue;
      float* out = cz + i * g.c_si + j * g.c_sj;
      const float y = g.alpha * acc[r][q];
      *out = g.beta != 0.f ? fmaf(g.beta, *out, y) : y;
    }
  }
}

// The sum of parts[z count + e] over z = 0 .. splits - 1, in order, into
// out[e] for e < split and out2[e - split] from there on.
__global__ void __launch_bounds__(kGemmThreads)
panel_sum(const float* __restrict__ parts, int splits, long long count,
          float* __restrict__ out, long long split, float* __restrict__ out2) {
  for (long long e = blockIdx.x * (long long)kGemmThreads + threadIdx.x; e < count;
       e += (long long)gridDim.x * kGemmThreads) {
    float s = parts[e];
#pragma unroll 8
    for (int z = 1; z < splits; ++z) s += parts[z * count + e];
    if (e < split)
      out[e] = s;
    else
      out2[e - split] = s;
  }
}

}  // namespace

// How many clusters of C CTAs with smem bytes of shared memory each can be
// resident at once (cudaOccupancyMaxActiveClusters) into *clusters; spill
// picks the large-panel instantiation.  Returns the cudaError_t.
extern "C" int svdt_panel_qr_clusters(int C, int smem, int spill, int* clusters) {
  return spill ? clusters_of<true>(C, smem, clusters) : clusters_of<false>(C, smem, clusters);
}

// Launches the panel QR on `stream` as one cluster of C CTAs under the plan
// (W, ws, ld, tc, tld, G, vec; smem bytes a CTA) of cluster_plan, T^T
// written with row stride ldt (b for a whole panel; the whole T's for a
// blocked panel's diagonal block); returns the launch's cudaError_t.
extern "C" int svdt_panel_qr(const float* Pt, float* Rt, float* Vt, float* Tt,
                             int b, int m, int r_off, int C, int W, int ws,
                             int ld, int tc, int tld, int G, int vec, int smem,
                             int ldt, void* stream) {
  if (tld < 1) return (int)cudaErrorInvalidValue;
  const Plan pl = {W, ws, ld, tc, tld, G, vec, ldt};
  if (ws < W)
    return launch<true>(Pt, Rt, Vt, Tt, b, m, r_off, C, pl, smem, stream);
  return launch<false>(Pt, Rt, Vt, Tt, b, m, r_off, C, pl, smem, stream);
}

// C_z = alpha A B (+ beta C) for the blocked panel's products, split z of
// K on blockIdx.z (see panel_gemm); returns the launch's cudaError_t.
extern "C" int svdt_panel_gemm(const float* a, const float* a2, long long a_si,
                               long long a_sk, int a_split, const float* b,
                               long long b_sk, long long b_sj, float* c,
                               long long c_si, long long c_sj, long long c_sz,
                               int M, int N, int K, int splits, float alpha,
                               float beta, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const int chunk = (K + splits - 1) / splits;
  const GemmArgs g = {a, a2, a_si, a_sk, a_split, b, b_sk, b_sj, c, c_si, c_sj, c_sz,
                      M, N, K, chunk, alpha, beta};
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, splits);
  panel_gemm<<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// The sum of the `splits` slices of `count` floats of parts, in order
// (the Gram's splits): its first `split` floats into out, the rest into
// out2; returns the launch's cudaError_t.
extern "C" int svdt_panel_sum(const float* parts, int splits, long long count,
                              float* out, long long split, float* out2,
                              void* stream) {
  if (splits < 1 || count < 1 || split < 0 || split > count)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (count + kGemmThreads - 1) / kGemmThreads;
  panel_sum<<<(int)(ctas < 1024 ? ctas : 1024), kGemmThreads, 0, (cudaStream_t)stream>>>(
      parts, splits, count, out, split, out2);
  return (int)cudaGetLastError();
}
