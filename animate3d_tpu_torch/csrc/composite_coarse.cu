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
// front to back; the coarse tile's fields sit in shared memory (24 KB at
// kc 512).
//   forward: one CTA of 256 threads per fine tile.
//   backward: one CTA per coarse tile loops its cs^2 fine tiles, as the TPU
//     grid step does, and writes its (12, kc) gradient block once: no global
//     atomics, the result is deterministic. Per fine tile, (1) a forward pass
//     keeps each pixel's transmittance at every block's start (registers,
//     kc / 128 floats); (2) the reverse pass recomputes one block from that
//     checkpoint into shared memory (T before each candidate, 128 x 256 f32
//     = 128 KB), so T_k needs no division by (1 - alpha); (3) it walks the
//     block back to front with the running suffix S = sum of dw w over later
//     candidates, reduces each candidate's 10 gradient rows over the warp by
//     shuffles (skipped where no pixel of the warp is live) and across the 8
//     warps in shared memory, in a fixed order.
//   dalpha = dw T_k - (S + g_T T_final) / (1 - alpha); the gradient passes
//   through alpha only where live, hit and raw <= 0.99.
// The alpha evaluation and the reverse walk's gradient terms are shared with
// kernel G (composite_common.cuh).
//
// Bound on the H100: at the recon shapes the least time is set by the bytes
// (fields read once, planes written once); the f32 arithmetic per evaluated
// (pixel, candidate) pair stays under it. Both kernels run well above that
// bound (PERF.md): each thread's walk over the candidates is sequential,
// and the backward reduces 10 sums over 4,096 pixels per candidate in one
// CTA per coarse tile. Not yet: splitting the backward's fine-tile loop
// over CTAs (with a second deterministic pass), warp-level early exit,
// tensor-core sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace composite;

constexpr int MAX_KC = 512;
constexpr int MAX_BLOCKS = MAX_KC / KB;
constexpr float T_STOP = 1e-4f;

// f: the coarse tile's fields in shared memory, row stride kc.
__device__ __forceinline__ bool tile_hit(const float* f, int kc, int k, float tx0,
                                         float ty0) {
  const float x = f[k], y = f[kc + k], r = f[11 * kc + k];
  return (x + r >= tx0) && (x - r < tx0 + TILE) && (y + r >= ty0) &&
         (y - r < ty0 + TILE);
}

// Hit flags of every candidate for the fine tile at (tx0, ty0).
__device__ __forceinline__ void mark_hits(const float* f, int kc, float tx0, float ty0,
                                          int* hit) {
  for (int k = threadIdx.x; k < kc; k += PX) hit[k] = tile_hit(f, kc, k, tx0, ty0);
}

__global__ void __launch_bounds__(PX)
    composite_coarse_fwd_kernel(const float* __restrict__ corig,
                                const float* __restrict__ fields, float* __restrict__ out,
                                int kc, int cs, float alpha_min, float alpha_max) {
  extern __shared__ float smem[];
  float* f = smem;                                 // NFIELD * kc
  int* hit = reinterpret_cast<int*>(f + NFIELD * kc);  // kc
  const int tiles = cs * cs;
  const int ci = blockIdx.x / tiles, local = blockIdx.x % tiles;
  const int tid = threadIdx.x;
  const float* src = fields + (size_t)ci * NFIELD * kc;
  for (int i = tid; i < NFIELD * kc; i += PX) f[i] = src[i];
  const float tx0 = corig[2 * ci] + (float)(local % cs) * TILE;
  const float ty0 = corig[2 * ci + 1] + (float)(local / cs) * TILE;
  const float gx = (float)(tid % TILE) + tx0, gy = (float)(tid / TILE) + ty0;
  __syncthreads();
  mark_hits(f, kc, tx0, ty0, hit);
  __syncthreads();

  const int kb = kc < KB ? kc : KB;
  float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, cd = 0.f, ca = 0.f;
  for (int b0 = 0; b0 < kc; b0 += kb) {
    const int any_hit = __syncthreads_or(tid < kb && hit[b0 + tid]);
    const int any_t = __syncthreads_or(T > T_STOP);
    if (!(any_hit && any_t)) continue;  // uniform over the CTA
    for (int k = b0; k < b0 + kb; ++k) {
      if (!hit[k]) continue;  // uniform
      const Alpha a = cand_alpha(f, kc, k, gx, gy, alpha_min, alpha_max);
      if (a.alpha > 0.f) {
        const float w = a.alpha * T;
        cr += w * f[6 * kc + k];
        cg += w * f[7 * kc + k];
        cb += w * f[8 * kc + k];
        cd += w * f[9 * kc + k];
        ca += w;
        T *= 1.f - a.alpha;
      }
    }
  }
  float* o = out + (size_t)blockIdx.x * 8 * PX + tid;
  o[0] = cr;
  o[PX] = cg;
  o[2 * PX] = cb;
  o[3 * PX] = ca;
  o[4 * PX] = cd;
  o[5 * PX] = T;
  o[6 * PX] = 0.f;
  o[7 * PX] = 0.f;
}

__global__ void __launch_bounds__(PX)
    composite_coarse_bwd_kernel(const float* __restrict__ corig,
                                const float* __restrict__ fields,
                                const float* __restrict__ cot, float* __restrict__ grad,
                                int kc, int cs, float alpha_min, float alpha_max) {
  extern __shared__ float smem[];
  float* f = smem;                       // NFIELD * kc
  float* gacc = f + NFIELD * kc;         // NGRAD * kc, summed over fine tiles
  float* tk = gacc + NGRAD * kc;         // KB * PX: T before each candidate
  float* red = tk + KB * PX;             // WARPS * NGRAD * KB
  int* hit = reinterpret_cast<int*>(red + WARPS * NGRAD * KB);  // kc
  const int tiles = cs * cs;
  const int ci = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* src = fields + (size_t)ci * NFIELD * kc;
  for (int i = tid; i < NFIELD * kc; i += PX) f[i] = src[i];
  for (int i = tid; i < NGRAD * kc; i += PX) gacc[i] = 0.f;
  const int kb = kc < KB ? kc : KB;
  const int nblocks = kc / kb;

  for (int local = 0; local < tiles; ++local) {
    const float tx0 = corig[2 * ci] + (float)(local % cs) * TILE;
    const float ty0 = corig[2 * ci + 1] + (float)(local / cs) * TILE;
    const float gx = (float)(tid % TILE) + tx0, gy = (float)(tid / TILE) + ty0;
    __syncthreads();  // fields loaded / previous tile's hit flags consumed
    mark_hits(f, kc, tx0, ty0, hit);
    __syncthreads();

    // pass 1: forward, keeping T at each block's start
    float tstart[MAX_BLOCKS];
    bool done[MAX_BLOCKS];
    float T = 1.f;
#pragma unroll
    for (int b = 0; b < MAX_BLOCKS; ++b) {
      tstart[b] = T;
      done[b] = false;
      if (b < nblocks) {
        const int b0 = b * kb;
        const int any_hit = __syncthreads_or(tid < kb && hit[b0 + tid]);
        const int any_t = __syncthreads_or(T > T_STOP);
        done[b] = any_hit && any_t;
        if (done[b]) {
          for (int k = b0; k < b0 + kb; ++k) {
            if (!hit[k]) continue;
            const Alpha a = cand_alpha(f, kc, k, gx, gy, alpha_min, alpha_max);
            if (a.alpha > 0.f) T *= 1.f - a.alpha;
          }
        }
      }
    }
    const float* g = cot + ((size_t)ci * tiles + local) * 8 * PX + tid;
    // r, g, b, alpha, depth and g_T * T_final
    const float gv[6] = {g[0], g[PX], g[2 * PX], g[3 * PX], g[4 * PX], g[5 * PX] * T};

    // pass 2: blocks back to front
    float S = 0.f;
#pragma unroll
    for (int b = MAX_BLOCKS - 1; b >= 0; --b) {
      if (b >= nblocks || !done[b]) continue;  // uniform
      const int b0 = b * kb;
      float t = tstart[b];
      for (int k = b0; k < b0 + kb; ++k) {  // T before each candidate
        tk[(k - b0) * PX + tid] = t;
        if (!hit[k]) continue;
        const Alpha a = cand_alpha(f, kc, k, gx, gy, alpha_min, alpha_max);
        if (a.alpha > 0.f) t *= 1.f - a.alpha;
      }
      for (int k = b0 + kb - 1; k >= b0; --k) {
        float c[NGRAD];
        const bool live = cand_grads(hit[k], f, kc, k, gx, gy, alpha_min, alpha_max,
                                     tk[(k - b0) * PX + tid], gv, S, c);
        warp_sum(c, live);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < NGRAD; ++r) red[(warp * NGRAD + r) * KB + (k - b0)] = c[r];
        }
      }
      __syncthreads();
      for (int i = tid; i < NGRAD * kb; i += PX) {
        const int r = i / kb, kk = i % kb;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[(w * NGRAD + r) * KB + kk];
        gacc[r * kc + b0 + kk] += s;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  float* dst = grad + (size_t)ci * NFIELD * kc;
  for (int i = tid; i < NGRAD * kc; i += PX) dst[i] = gacc[i];
  for (int i = tid; i < (NFIELD - NGRAD) * kc; i += PX) dst[NGRAD * kc + i] = 0.f;
}

size_t fwd_smem(int kc) { return (size_t)NFIELD * kc * sizeof(float) + kc * sizeof(int); }

size_t bwd_smem(int kc) {
  return ((size_t)(NFIELD + NGRAD) * kc + (size_t)KB * PX + (size_t)WARPS * NGRAD * KB) *
             sizeof(float) +
         kc * sizeof(int);
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
// forward's inputs and the planes' cotangent cot (n_ct, cs*cs, 8, 256).
extern "C" int composite_coarse_bwd(const void* corig, const void* fields, const void* cot,
                                    void* grad, int n_ct, int kc, int cs, float alpha_min,
                                    float alpha_max, void* stream) {
  int bad = check_shape(n_ct, kc, cs);
  if (bad) return bad;
  const size_t smem = bwd_smem(kc);
  cudaError_t err = cudaFuncSetAttribute(composite_coarse_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_coarse_bwd_kernel<<<n_ct, PX, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(corig), static_cast<const float*>(fields),
      static_cast<const float*>(cot), static_cast<float*>(grad), kc, cs, alpha_min,
      alpha_max);
  return (int)cudaGetLastError();
}

extern "C" const char* composite_coarse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
