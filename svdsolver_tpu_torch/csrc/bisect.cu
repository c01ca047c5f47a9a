// All singular values of a bidiagonal by parallel multisection on the
// Golub-Kahan tridiagonal: a bisection tree per singular value, spread over
// a group of G threads (bisect_tree_kernel), or one thread per singular
// value (bisect_kernel, the first design, kept for timings in turns).
//
// Replaces: svdsolver_tpu/ops/pallas/bisect.py, _bisect_kernel.  Same
// arithmetic: the z^2 streams and the bound are prepared by the wrapper as
// there; each sweep probes `probes` equispaced points of the bracket; the
// Sturm count is the twisted one (forward pivots p from the top and backward
// pivots q from the bottom run in the same step and meet at the twist n+1:
// count = #neg(p) + #neg(q) + (gamma < 0) with gamma = p + q + lam); and the
// bracket keeps its untouched endpoint exact.
//
// What bounds it on the H100: each count is a chain of n dependent steps,
// each with two independent IEEE divisions, so a thread is bound by the
// division latency along the chain (~78 ns a step measured), iters * n
// steps long for one thread a sigma.  The card's issue rate is nearly
// unused by that: one warp on each of 120 SMs at n = 3840.
//
// Design (the tree): a sweep's bracket depends only on the previous one and
// on na, the count of probes below sigma (a digit in 0..P), so the brackets
// of the next T sweeps form a (P+1)-ary tree with (P+1)^T - 1 probe points.
// Thread t of a group of G (a power of two dividing 32; (P+1)^T - 1 <= G)
// owns one probe of one node: it replays the node's digit path from the
// group's bracket with the very roundings of the sweep (sweep_step), runs
// one count chain, and a __ballot_sync hands every thread of the group all
// the indicators; the group then walks T levels down the tree, each level's
// na a popc over that node's P bits.  One chain length resolves T sweeps
// (the last round a partial tree when T does not divide iters), and every
// sigma is bit-equal to the one-thread design's: the same probes are
// counted, each with the same lam.  G = 16 gives T = 4 at probes = 1 and
// T = 2 at probes = 3: 9 chain lengths in place of 35 at probes = 1, with
// 16 times the warps.  The z^2 streams are staged in shared memory (8n
// bytes a block), where the whole warp reads the same word each step (a
// broadcast); the wrapper sizes the blocks so that an SM holds at least 16
// warps wherever the streams let it (128 threads at n = 3840, 512 from
// n = 15,360 on, one block an SM).
//
// The first design (bisect_kernel, reached by the wrapper's _group=1 and by
// probes > 32, where no tree fits a warp): one thread a sigma in blocks of
// 32, n = 3840 lanes on 120 SMs, the two chains of a step hiding half the
// division latency.
//
// Compiled without fast math: zero pivots must give inf and no value may
// flush to zero.  __fmul_rn/__fadd_rn keep the probe points from
// contracting into an FMA, so they round as the plain PyTorch version's do.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ int twisted_count(const float* zf, const float* zr,
                                             int n, float lam) {
  float p = -lam;  // p_1
  float q = -lam;  // the backward chain starts with a sacrificial zero z^2
  int cnt = p < 0.f;
  for (int s = 0; s < n; ++s) {
    p = -lam - zf[s] / p;
    q = -lam - zr[s] / q;
    cnt += (p < 0.f) + (q < 0.f);
  }
  const float gamma = p + q + lam;  // twist pivot (zero TGK diagonal)
  // p_{n+1}, q_{n+1} were counted in the loop but belong to the twist
  return cnt - (p < 0.f) - (q < 0.f) + (gamma < 0.f);
}

// One sweep's bracket update for the digit na (probes below sigma).
__device__ __forceinline__ void sweep_step(float& lo, float& hi, int na,
                                           float kp1, int probes) {
  const float h = (hi - lo) / kp1;
  lo = __fadd_rn(lo, __fmul_rn((float)na, h));
  // keep the untouched endpoint exact: lo + (k+1) h != hi in floating point
  hi = na >= probes ? hi : __fadd_rn(lo, h);
}

__global__ void __launch_bounds__(kThreads)
bisect_kernel(const float* __restrict__ z2f, const float* __restrict__ z2r,
              const float* __restrict__ bound, float* __restrict__ out, int n,
              int iters, int probes) {
  extern __shared__ float zs[];  // z2f then z2r, n floats each
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    zs[i] = z2f[i];
    zs[n + i] = z2r[i];
  }
  __syncthreads();
  const int ks = blockIdx.x * blockDim.x + threadIdx.x;  // ks-th smallest
  if (ks >= n) return;
  const float kp1 = (float)(probes + 1);
  float lo = 0.f;
  float hi = *bound;
  for (int it = 0; it < iters; ++it) {
    const float h = (hi - lo) / kp1;
    int na = 0;  // probes below sigma_ks
    for (int j = 0; j < probes; ++j) {
      const float lam = __fadd_rn(lo, __fmul_rn((float)(j + 1), h));
      na += twisted_count(zs, zs + n, n, lam) - n <= ks;
    }
    sweep_step(lo, hi, na, kp1, probes);
  }
  out[n - 1 - ks] = 0.5f * (lo + hi);  // descending
}

// The tree: G threads a sigma, T levels a round (see the header).
__global__ void __launch_bounds__(1024)
bisect_tree_kernel(const float* __restrict__ z2f,
                   const float* __restrict__ z2r,
                   const float* __restrict__ bound, float* __restrict__ out,
                   int n, int iters, int probes, int G, int T) {
  extern __shared__ float zs[];  // z2f then z2r, n floats each
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    zs[i] = z2f[i];
    zs[n + i] = z2r[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int t = lane & (G - 1);  // place in the group
  const int gbase = lane - t;
  const int ks = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / G);
  const bool live = ks < n;  // the tail's threads still join the ballots
  const int P = probes;
  const int P1 = probes + 1;
  // this thread's probe: level l, node q (l base-P1 digits, root first),
  // probe j of the node; threads past (P+1)^T - 1 probe nothing (l == T)
  int l = 0, first = 0, width = P;
  while (l < T && t >= first + width) {
    first += width;
    width *= P1;
    ++l;
  }
  const int q = (t - first) / P;
  const int j = (t - first) - q * P;
  int top = 1;  // P1^(l-1): the weight of the root's digit
  for (int s = 1; s < l; ++s) top *= P1;
  const unsigned node_bits = P >= 32 ? 0xffffffffu : (1u << P) - 1u;
  const float kp1 = (float)P1;
  float lo = 0.f;
  float hi = *bound;
  for (int done = 0; done < iters; done += T) {
    const int R = min(T, iters - done);  // levels this round
    bool below = false;
    if (live && l < R) {
      float nlo = lo, nhi = hi;
      for (int s = 0, w = top; s < l; ++s, w /= P1)
        sweep_step(nlo, nhi, (q / w) % P1, kp1, P);
      const float h = (nhi - nlo) / kp1;
      const float lam = __fadd_rn(nlo, __fmul_rn((float)(j + 1), h));
      below = twisted_count(zs, zs + n, n, lam) - n <= ks;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, below) >> gbase;
    int off = 0, node = 0, lw = P;  // level's first bit, node, bits a level
    for (int lv = 0; lv < R; ++lv) {
      const int na = __popc((bits >> (off + node * P)) & node_bits);
      sweep_step(lo, hi, na, kp1, P);
      off += lw;
      lw *= P1;
      node = node * P1 + na;
    }
  }
  if (live && t == 0) out[n - 1 - ks] = 0.5f * (lo + hi);  // descending
}

}  // namespace

// Launches the bisection on `stream`; returns the launch's cudaError_t.
extern "C" int svdt_bisect(const float* z2f, const float* z2r,
                           const float* bound, float* out, int n, int iters,
                           int probes, void* stream) {
  // both z^2 streams; the wrapper checks they fit
  const size_t smem = 2 * sizeof(float) * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(
      bisect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kThreads - 1) / kThreads;
  bisect_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      z2f, z2r, bound, out, n, iters, probes);
  return (int)cudaGetLastError();
}

// Launches the tree kernel on `stream`: groups of G threads a sigma, T
// levels a round, blocks of `threads`; returns the launch's cudaError_t.
extern "C" int svdt_bisect_tree(const float* z2f, const float* z2r,
                                const float* bound, float* out, int n,
                                int iters, int probes, int G, int T,
                                int threads, void* stream) {
  if (G < 1 || G > 32 || (G & (G - 1)) || T < 1 || threads % 32 ||
      threads < 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(
      bisect_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n * G;
  const int blocks = (int)((total + threads - 1) / threads);
  bisect_tree_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      z2f, z2r, bound, out, n, iters, probes, G, T);
  return (int)cudaGetLastError();
}
