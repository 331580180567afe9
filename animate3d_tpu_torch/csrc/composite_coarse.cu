// Coarse-direct gaussian compositing (kernel H) for Hopper (sm_90a), f32,
// forward and hand-derived backward.
//
// Replaces: animate3d_tpu/ops/rasterize_pallas.py::_composite_coarse_kernel
// (forward, via composite_coarse_pallas) and ::_composite_coarse_bwd_kernel
// (backward, via composite_coarse_pallas_bwd), the compositing stage of the
// rasterizer's coarse-direct route (animate3d_tpu/ops/rasterize.py:595-634).
//
// Inputs per coarse tile ci: its pixel origin corig[ci] = (x0, y0) and its
// depth-sorted candidate fields (12, kc) f32, rows 0 x, 1 y, 2-4 conic
// (a, b, c), 5 opacity, 6-8 rgb, 9 depth, 10 ok, 11 3-sigma radius. The
// coarse tile covers cs x cs fine 16x16 tiles. Semantics, as the TPU kernels:
//   * pixel centres at origin + (x, y), no +0.5;
//   * power = -0.5 (a dx^2 + c dy^2) - b dx dy, alpha = min(0.99, o e^power),
//     live where power <= 0, alpha >= 1/255 and ok > 0, and zero where the
//     candidate's AABB (radius row) misses the fine tile;
//   * candidates in blocks of kb = min(kc, 128); a block is skipped for the
//     whole fine tile when no candidate of it hits the tile, or when the
//     largest transmittance over the tile's 256 pixels is <= 1e-4 at the
//     block's start (one __syncthreads_or each);
//   * planes per fine tile: r, g, b, accumulated alpha, depth, T_final, 0, 0.
//
// Design. The TPU puts K on lanes (log-step prefix products over a 256 x kc
// VMEM scratch). Here one thread owns one pixel and walks the candidates
// front to back. Both directions first list the fine tile's hit candidates
// (build_hit_list: the candidates whose AABB meets the fine tile, by ballot
// and prefix, front to back), so the walks visit only those: about 18 of
// 512 on an average fine tile of the recon asset.
//   forward: one CTA of 256 threads per fine tile. It loads the coarse
//     tile's three AABB rows (0, 1, 11: 6 KB at kc 512, one 16-byte load or
//     two a thread, all in flight together), lists the hits, then gathers
//     only the listed candidates' rows 0-10 into 48-byte records (three
//     16-byte shared loads a candidate in the walk), so a fine tile reads
//     6 KB plus 44 bytes a hit where it read all 24 KB with a load a float
//     in turn. The walk runs block by block over the list; a block is
//     skipped at the kb boundaries of the original candidate index exactly
//     where the TPU kernel skips it (no listed candidate in it, or the
//     largest T over the tile <= 1e-4 at its start: one __syncthreads_or,
//     and then every later block is skipped too). Within a block every
//     pixel composites every listed candidate, as the TPU kernel does: no
//     per-pixel or per-warp exit, so T_final keeps falling under 1e-4. A
//     warp passes over a candidate without its exp only where all its 32
//     pixels' power lies under log(alpha_min / opacity) less a margin, so
//     that alpha < alpha_min there for certain (composite_records). Each
//     pixel does the float operations of the earlier all-candidates walk in
//     the same order, so the planes are the same bits. A multicast of the
//     whole 24 KB over a cluster of the coarse tile's 16 CTAs was slower
//     at every path row (PERF.md).
//   backward: a thread-block cluster of `ranks` CTAs per coarse tile;
//     rank r takes fine tiles r, r + ranks, ..., so with ranks > 1 a coarse
//     tile's fine tiles run in parallel where the TPU's grid step walks them
//     in turn. The caller picks ranks (1 to min(cs^2, 16), 16 being the
//     non-portable cluster size) so that the grid holds enough CTAs: every
//     rank waits at the cluster barrier for the cluster's slowest fine
//     tile, so on the recon asset, whose fine tiles differ a lot in work,
//     one CTA a fine tile costs more than it gains once the coarse tiles
//     alone fill the card (ops/rasterize.py::coarse_bwd_ranks). The coarse
//     tile's fields sit in shared memory (24 KB at kc 512). Per fine tile,
//     (0) the hit list; (1) a forward pass
//     keeps each pixel's transmittance at the start of every sub-block of
//     SB = 32 listed candidates (shared memory, as kernel G does); (2) back
//     to front, each sub-block's T before every candidate is recomputed from
//     that checkpoint into shared memory, so T_k needs no division by
//     (1 - alpha); (3) the sub-block is walked back to front with the
//     running suffix S = sum of dw w over later candidates; a candidate's 10
//     gradient terms are summed over the warp by shuffles (skipped where no
//     pixel of the warp is live) and across the 8 warps in shared memory in
//     a fixed order, into the rank's (10, kc) block. (4) After a cluster
//     barrier each rank sums the ranks' blocks in rank order over
//     distributed shared memory for its slice of the candidates and writes
//     that slice of the (12, kc) gradient once: no global atomics, the
//     result is deterministic. 104 KB of shared memory at kc 512 (two CTAs
//     an SM; a T buffer for a whole 128-candidate block, 128 KB, would leave
//     one). A global scratch of per-fine-tile partials summed by a second
//     pass would be as deterministic, but costs n_ct cs^2 10 kc 4 bytes,
//     335 MB at the recon step, written and read once more.
//   dalpha = dw T_k - (S + g_T T_final) / (1 - alpha); the gradient passes
//   through alpha only where live, hit and raw <= 0.99.
// The alpha evaluation and the reverse walk's gradient terms are shared with
// kernel G (composite_common.cuh).
//
// Bound on the H100: at the recon shapes the least time is set by the bytes
// (fields read once, planes written once: the 8 planes of 256 f32 a fine
// tile are 134 MB of the recon step's 159 MB); on dense tiles by the f32
// arithmetic per evaluated (pixel, candidate) pair. The forward is held by
// its walk's issue rate, about 45 instructions a warp and candidate where
// the warp does not skip (20 where it does), and on the faint recon asset
// by each fine tile's chain of two dependent loads and five barriers; the
// backward evaluates each listed pair three times and spends 50 shuffles a
// warp on every listed candidate (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace composite;

constexpr int MAX_KC = 512;
constexpr float T_STOP = 1e-4f;
constexpr int SB = 32;           // candidates per recomputed sub-block of the backward
constexpr int MAX_CLUSTER = 16;  // CTAs (fine tiles) of one coarse tile's cluster

// Whether candidate k's AABB (rows x, y and radius) meets the fine tile at (tx0, ty0).
__device__ __forceinline__ bool tile_hit(const float* xr, const float* yr, const float* rr,
                                         int k, float tx0, float ty0) {
  const float x = xr[k], y = yr[k], r = rr[k];
  return (x + r >= tx0) && (x - r < tx0 + TILE) && (y + r >= ty0) &&
         (y - r < ty0 + TILE);
}

// The fine tile's hit list, shared by the forward and the backward: the
// candidates k < kc whose AABB meets the fine tile at (tx0, ty0), front to
// back, in hl[0, n) (build_list); gpre[g] counts the hits before
// 32-candidate group g, gpre[ngrp] = n.
__device__ __forceinline__ void build_hit_list(const float* xr, const float* yr,
                                               const float* rr, int kc, float tx0, float ty0,
                                               int* hl, unsigned* gbal, int* gpre) {
  build_list(kc, [&](int k) { return tile_hit(xr, yr, rr, k, tx0, ty0); }, hl, gbal, gpre);
}

// hits of the list before block b's first candidate (blocks of kb = min(kc, 128))
__device__ __forceinline__ int hits_before(const int* gpre, int ngrp, int kb, int b) {
  return gpre[min(ngrp, (b * kb + 31) / 32)];
}

// A listed candidate's record in the forward: rows 0-10, then the skip
// threshold (48 bytes, three 16-byte shared loads).
constexpr int REC = 12;

// The power under which a candidate's alpha is below alpha_min for certain:
// log(alpha_min / opacity) less a margin far above the rounding of logf,
// expf and the product; +inf where it is never live (not ok, or no opacity
// against a positive alpha_min), -inf where alpha_min <= 0.
__device__ __forceinline__ float skip_below(float opacity, float ok, float alpha_min) {
  if (!(ok > 0.f)) return INFINITY;
  if (!(alpha_min > 0.f)) return -INFINITY;
  if (!(opacity > 0.f)) return INFINITY;
  return logf(alpha_min / opacity) - SKIP_MARGIN;
}

struct Planes {
  float T = 1.f, r = 0.f, g = 0.f, b = 0.f, d = 0.f, a = 0.f;
};

// Composites the n records of rec, front to back, into this pixel's planes:
// the float operations of cand_alpha and the TPU kernel's accumulation, in
// order. A candidate whose power is under its skip threshold at all 32
// pixels of the warp has alpha < alpha_min there, so the warp moves on
// without its exp: nothing of the result changes.
__device__ __forceinline__ void composite_records(const float* rec, int n, float gx, float gy,
                                                  float alpha_min, float alpha_max, Planes& p) {
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    float c[REC];
    const float4* r4 = reinterpret_cast<const float4*>(rec + j * REC);
#pragma unroll
    for (int q = 0; q < REC / 4; ++q) {
      const float4 x = r4[q];
      c[4 * q] = x.x;
      c[4 * q + 1] = x.y;
      c[4 * q + 2] = x.z;
      c[4 * q + 3] = x.w;
    }
    float dx, dy;
    const float power = cand_power(c, 1, 0, gx, gy, dx, dy);
    if (!__any_sync(0xffffffffu, power >= c[11])) continue;
    const float raw = __fmul_rn(c[5], expf(power));
    const float alpha = fminf(alpha_max, raw);
    // ok > 0 holds here: skip_below() puts a candidate that is not ok past every power
    const bool live = power <= 0.f && alpha >= alpha_min;
    if ((live ? alpha : 0.f) > 0.f) {
      const float w = alpha * p.T;
      p.r += w * c[6];
      p.g += w * c[7];
      p.b += w * c[8];
      p.d += w * c[9];
      p.a += w;
      p.T *= 1.f - alpha;
    }
  }
}

__global__ void __launch_bounds__(PX)
    composite_coarse_fwd_kernel(const float* __restrict__ corig,
                                const float* __restrict__ fields, float* __restrict__ out,
                                int kc, int cs, float alpha_min, float alpha_max) {
  extern __shared__ float4 smem4[];
  const int ngrp = (kc + 31) / 32;
  float* rec = reinterpret_cast<float*>(smem4);  // kc * REC: listed candidates, list order
  float* ab = rec + kc * REC;                     // 3 * kc: rows 0, 1, 11 of every candidate
  int* hl = reinterpret_cast<int*>(ab + 3 * kc);  // kc: the fine tile's hit list
  unsigned* gbal = reinterpret_cast<unsigned*>(hl + kc);  // ngrp: hit bits a group
  int* gpre = reinterpret_cast<int*>(gbal + ngrp);        // ngrp + 1: hits before it
  const int tiles = cs * cs;
  const int ci = blockIdx.x / tiles, local = blockIdx.x % tiles;
  const int tid = threadIdx.x;
  const float* src = fields + (size_t)ci * NFIELD * kc;
  if (kc % 4 == 0) {  // rows 0, 1, 11 as 16-byte loads, all in flight together
    constexpr int MAXV = (3 * MAX_KC / 4 + PX - 1) / PX;
    const int q4 = kc / 4;
    float4 v[MAXV];
#pragma unroll
    for (int n = 0; n < MAXV; ++n) {
      const int i = tid + n * PX, row = i / q4;
      if (i < 3 * q4)
        v[n] = reinterpret_cast<const float4*>(src + (row == 2 ? 11 : row) * kc)[i - row * q4];
    }
#pragma unroll
    for (int n = 0; n < MAXV; ++n)
      if (tid + n * PX < 3 * q4) reinterpret_cast<float4*>(ab)[tid + n * PX] = v[n];
  } else {
    for (int i = tid; i < kc; i += PX) {
      ab[i] = src[i];
      ab[kc + i] = src[kc + i];
      ab[2 * kc + i] = src[11 * kc + i];
    }
  }
  const float tx0 = corig[2 * ci] + (float)(local % cs) * TILE;
  const float ty0 = corig[2 * ci + 1] + (float)(local / cs) * TILE;
  const float gx = (float)(tid % TILE) + tx0, gy = (float)(tid / TILE) + ty0;
  __syncthreads();
  build_hit_list(ab, ab + kc, ab + 2 * kc, kc, tx0, ty0, hl, gbal, gpre);
  // only the listed candidates' other rows leave device memory
  const int n = gpre[ngrp];
  for (int i = tid; i < REC * n; i += PX) {
    const int r = i / n, j = i - r * n, k = hl[j];
    rec[j * REC + r] = r < 2    ? ab[r * kc + k]
                       : r < 11 ? src[r * kc + k]
                                : skip_below(src[5 * kc + k], src[10 * kc + k], alpha_min);
  }
  __syncthreads();

  const int kb = kc < KB ? kc : KB;
  const int nblocks = kc / kb;
  Planes p;
  for (int b = 0; b < nblocks; ++b) {
    const int lo = hits_before(gpre, ngrp, kb, b), hi = hits_before(gpre, ngrp, kb, b + 1);
    if (hi == lo) continue;  // no candidate of the block hits the tile: uniform
    // the largest T at the block's start <= 1e-4: T never rises, so every
    // later block is skipped too
    if (!__syncthreads_or(p.T > T_STOP)) break;
    composite_records(rec + lo * REC, hi - lo, gx, gy, alpha_min, alpha_max, p);
  }
  float* o = out + (size_t)blockIdx.x * 8 * PX + tid;
  o[0] = p.r;
  o[PX] = p.g;
  o[2 * PX] = p.b;
  o[3 * PX] = p.a;
  o[4 * PX] = p.d;
  o[5 * PX] = p.T;
  o[6 * PX] = 0.f;
  o[7 * PX] = 0.f;
}

// A cluster of Q CTAs (ranks) a coarse tile: rank r walks fine tiles r,
// r + Q, ... and sums their gradient terms into its own shared-memory block
// `part`; then each rank adds the Q blocks in rank order over distributed
// shared memory for its slice of the candidates and writes that slice of
// the (12, kc) gradient once.
__global__ void __launch_bounds__(PX, 2)
    composite_coarse_bwd_kernel(const float* __restrict__ corig,
                                const float* __restrict__ fields,
                                const float* __restrict__ cot, float* __restrict__ grad,
                                int kc, int cs, float alpha_min, float alpha_max) {
  cg::cluster_group cluster = cg::this_cluster();
  const int Q = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ float smem[];
  const int nsb = (kc + SB - 1) / SB;   // sub-blocks of a fine tile's hit list, at most
  const int ngrp = (kc + 31) / 32;      // 32-candidate groups
  float* f = smem;                      // NFIELD * kc
  float* part = f + NFIELD * kc;        // NGRAD * kc: this rank's fine tiles' sums
  float* tsb = part + NGRAD * kc;       // nsb * PX: T at each sub-block's start
  float* tk = tsb + nsb * PX;           // SB * PX: T before each candidate of one sub-block
  float* red = tk + SB * PX;            // WARPS * NGRAD * SB
  int* hl = reinterpret_cast<int*>(red + WARPS * NGRAD * SB);  // kc: the tile's hit list
  unsigned* gbal = reinterpret_cast<unsigned*>(hl + kc);       // ngrp: hit bits a group
  int* gpre = reinterpret_cast<int*>(gbal + ngrp);             // ngrp + 1: hits before it
  const int tiles = cs * cs;
  const int ci = blockIdx.x / Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* src = fields + (size_t)ci * NFIELD * kc;
  for (int i = tid; i < NFIELD * kc; i += PX) f[i] = src[i];
  for (int i = tid; i < NGRAD * kc; i += PX) part[i] = 0.f;
  const int kb = kc < KB ? kc : KB;
  const int nblocks = kc / kb;

  for (int local = rank; local < tiles; local += Q) {
    const float tx0 = corig[2 * ci] + (float)(local % cs) * TILE;
    const float ty0 = corig[2 * ci + 1] + (float)(local / cs) * TILE;
    const float gx = (float)(tid % TILE) + tx0, gy = (float)(tid / TILE) + ty0;
    __syncthreads();  // fields loaded / the previous tile's list consumed

    // the hit list, so that the walks below skip the other candidates for free
    build_hit_list(f, f + kc, f + 11 * kc, kc, tx0, ty0, hl, gbal, gpre);

    // pass 1: forward, keeping T at each sub-block's start; a block runs
    // where a candidate of it hits the tile and some pixel's T > 1e-4
    unsigned ran = 0;
    int sbi = 0;  // sub-blocks so far
    float T = 1.f;
    for (int b = 0; b < nblocks; ++b) {
      const int lo = hits_before(gpre, ngrp, kb, b), hi = hits_before(gpre, ngrp, kb, b + 1);
      if (hi == lo || !__syncthreads_or(T > T_STOP)) continue;  // uniform over the CTA
      ran |= 1u << b;
      for (int j0 = lo; j0 < hi; j0 += SB, ++sbi) {
        tsb[sbi * PX + tid] = T;
        const int j1 = min(hi, j0 + SB);
        for (int j = j0; j < j1; ++j) {
          const Alpha a = cand_alpha(f, kc, hl[j], gx, gy, alpha_min, alpha_max);
          if (a.alpha > 0.f) T *= 1.f - a.alpha;
        }
      }
    }
    const float* g = cot + ((size_t)ci * tiles + local) * 8 * PX + tid;
    // r, g, b, alpha, depth and g_T * T_final
    const float gv[6] = {g[0], g[PX], g[2 * PX], g[3 * PX], g[4 * PX], g[5 * PX] * T};

    // pass 2: the blocks that ran, back to front, a sub-block at a time
    float S = 0.f;
    for (int b = nblocks - 1; b >= 0; --b) {
      if (!((ran >> b) & 1u)) continue;  // uniform
      const int lo = hits_before(gpre, ngrp, kb, b), hi = hits_before(gpre, ngrp, kb, b + 1);
      const int ns = (hi - lo + SB - 1) / SB;
      sbi -= ns;
      for (int s = ns - 1; s >= 0; --s) {
        const int j0 = lo + s * SB, n = min(SB, hi - j0);
        float t = tsb[(sbi + s) * PX + tid];
        for (int q = 0; q < n; ++q) {
          tk[q * PX + tid] = t;
          const Alpha a = cand_alpha(f, kc, hl[j0 + q], gx, gy, alpha_min, alpha_max);
          if (a.alpha > 0.f) t *= 1.f - a.alpha;
        }
        for (int q = n - 1; q >= 0; --q) {
          float c[NGRAD];
          const int k = hl[j0 + q];
          const bool live = alpha_grads(cand_alpha(f, kc, k, gx, gy, alpha_min, alpha_max), f,
                                        kc, k, alpha_max, tk[q * PX + tid], gv, S, c);
          warp_sum(c, live);
          if (lane == 0) {
#pragma unroll
            for (int r = 0; r < NGRAD; ++r) red[(warp * NGRAD + r) * SB + q] = c[r];
          }
        }
        __syncthreads();
        for (int i = tid; i < NGRAD * n; i += PX) {
          const int r = i / n, q = i % n;
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) sum += red[(w * NGRAD + r) * SB + q];
          part[r * kc + hl[j0 + q]] += sum;
        }
        __syncthreads();  // red and tk are reused by the next sub-block
      }
    }
  }

  // the cluster's sum, rank by rank in order, one slice of candidates a rank
  cluster.sync();
  const int slice = (kc + Q - 1) / Q;
  const int lo = min(kc, rank * slice), len = min(kc, lo + slice) - lo;
  float* dst = grad + (size_t)ci * NFIELD * kc;
  for (int i = tid; i < NGRAD * len; i += PX) {
    const int r = i / len, k = lo + i % len;
    float sum = 0.f;
    for (int q = 0; q < Q; ++q) sum += cluster.map_shared_rank(part, q)[r * kc + k];
    dst[r * kc + k] = sum;
  }
  for (int i = tid; i < (NFIELD - NGRAD) * len; i += PX)
    dst[(NGRAD + i / len) * kc + lo + i % len] = 0.f;
  cluster.sync();  // no rank leaves while another reads its block
}

size_t fwd_smem(int kc) {
  return (size_t)(REC + 3) * kc * sizeof(float) + (kc + 2 * ((kc + 31) / 32) + 1) * sizeof(int);
}

size_t bwd_smem(int kc) {
  const size_t nsb = (kc + SB - 1) / SB, ngrp = (kc + 31) / 32;
  return ((size_t)(NFIELD + NGRAD) * kc + (nsb + SB) * PX + (size_t)WARPS * NGRAD * SB) *
             sizeof(float) +
         (kc + 2 * ngrp + 1) * sizeof(int);
}

int check_shape(int n_ct, int kc, int cs) {
  if (n_ct <= 0 || cs <= 0 || kc <= 0 || kc > MAX_KC) return (int)cudaErrorInvalidValue;
  if (kc > KB && kc % KB != 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// planes (n_ct, cs*cs, 8, 256) from corig (n_ct, 2) and fields (n_ct, 12, kc),
// all f32 and contiguous; kc <= 128, or a multiple of 128 up to 512.
extern "C" int composite_coarse_fwd(const void* corig, const void* fields, void* out,
                                    int n_ct, int kc, int cs, float alpha_min,
                                    float alpha_max, void* stream) {
  int bad = check_shape(n_ct, kc, cs);
  if (bad) return bad;
  const size_t smem = fwd_smem(kc);
  cudaError_t err = cudaFuncSetAttribute(composite_coarse_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_coarse_fwd_kernel<<<n_ct * cs * cs, PX, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(corig), static_cast<const float*>(fields),
      static_cast<float*>(out), kc, cs, alpha_min, alpha_max);
  return (int)cudaGetLastError();
}

// grad (n_ct, 12, kc): rows 0-9 the field gradients, rows 10-11 zero, from the
// forward's inputs and the planes' cotangent cot (n_ct, cs*cs, 8, 256); a
// cluster of `ranks` CTAs (1 to min(cs*cs, 16)) per coarse tile.
extern "C" int composite_coarse_bwd(const void* corig, const void* fields, const void* cot,
                                    void* grad, int n_ct, int kc, int cs, int ranks,
                                    float alpha_min, float alpha_max, void* stream) {
  int bad = check_shape(n_ct, kc, cs);
  if (bad) return bad;
  if (ranks < 1 || ranks > MAX_CLUSTER || ranks > cs * cs) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(kc);
  cudaError_t err = cudaFuncSetAttribute(composite_coarse_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(composite_coarse_bwd_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ct * ranks);
  cfg.blockDim = dim3(PX);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, composite_coarse_bwd_kernel, static_cast<const float*>(corig),
                           static_cast<const float*>(fields), static_cast<const float*>(cot),
                           static_cast<float*>(grad), kc, cs, alpha_min, alpha_max);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* composite_coarse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
