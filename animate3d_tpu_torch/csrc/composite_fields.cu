// Per-tile gaussian compositing (kernel G) for Hopper (sm_90a), f32,
// forward and hand-derived backward.
//
// Replaces: animate3d_tpu/ops/rasterize_pallas.py::_composite_fields_kernel
// (forward, via composite_fields_pallas) and ::_composite_fields_bwd_kernel
// (backward, via composite_fields_pallas_bwd), the compositing stage of the
// rasterizer's fields route: an image of at most coarse^2 fine tiles
// (animate3d_tpu/ops/rasterize.py:636-650), 64^2 and below at tile 16.
//
// Inputs per 16x16 tile ti: its pixel origin origins[ti] = (x0, y0) and the
// fields (12, K) f32 of its K depth-sorted candidates, rows 0 x, 1 y, 2-4
// conic (a, b, c), 5 opacity, 6-8 rgb, 9 depth, 10 ok, 11 zero (unread).
// Semantics, as the TPU kernels:
//   * pixel centres at origin + (x, y), no +0.5;
//   * alpha = min(0.99, o e^power), live where power <= 0, alpha >= 1/255
//     and ok > 0 (composite_common.cuh);
//   * all K candidates composited front to back at every pixel: no early
//     stop and no tile gate;
//   * planes per tile: r, g, b, accumulated alpha, depth, T_final, 0, 0.
//
// Design. The TPU puts K on lanes (log-step prefix products over a 256 x K
// VMEM scratch). Here one thread owns one pixel and walks the candidates;
// one CTA of 256 threads owns one tile and keeps its fields (rows 0-10) in
// shared memory (11 KB at K = 256).
//   forward: one pass front to back.
//   backward: the CTA writes its tile's (12, K) gradient block once: no
//     atomics, the result is deterministic. (1) A forward pass keeps each
//     pixel's transmittance at the start of every sub-block of SB = 32
//     candidates (shared memory, K / 32 floats a pixel); (2) back to front,
//     each sub-block's T before every candidate is recomputed from that
//     checkpoint into shared memory (32 x 256 f32 = 32 KB), so T_k needs no
//     division by (1 - alpha); (3) the sub-block is walked back to front
//     with the running suffix S = sum of dw w over later candidates; each
//     candidate's 10 gradient terms are summed over the warp by shuffles
//     (skipped where no pixel of the warp is live) and across the 8 warps
//     in shared memory, in a fixed order. 61 KB of shared memory at K = 256:
//     three CTAs an SM.
//
// Bound on the H100: every (pixel, candidate) pair is evaluated (about 14
// f32 operations, plus 12 forward / 40 backward where alpha is live), so at
// the recon shapes the least time is set by the operations, not the bytes
// (fields read once, planes written once). The walk over the candidates is
// sequential per thread, and the backward evaluates each pair three times
// and spends 50 shuffles a warp on every candidate. Not yet: a warp-wide
// transpose reduction, per-warp early exit on all-transparent pixels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace composite;

constexpr int NROWS = 11;  // rows read by the kernels: 0-10
constexpr int SB = 32;     // candidates per recomputed sub-block of the backward
constexpr int MAX_K = 1024;

__global__ void __launch_bounds__(PX)
    composite_fields_fwd_kernel(const float* __restrict__ origins,
                                const float* __restrict__ fields, float* __restrict__ out,
                                int K, float alpha_min, float alpha_max) {
  extern __shared__ float f[];  // NROWS * K
  const int ti = blockIdx.x, tid = threadIdx.x;
  const float* src = fields + (size_t)ti * NFIELD * K;
  for (int i = tid; i < NROWS * K; i += PX) f[i] = src[i];
  const float gx = (float)(tid % TILE) + origins[2 * ti];
  const float gy = (float)(tid / TILE) + origins[2 * ti + 1];
  __syncthreads();

  float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, cd = 0.f, ca = 0.f;
  for (int k = 0; k < K; ++k) {
    const Alpha a = cand_alpha(f, K, k, gx, gy, alpha_min, alpha_max);
    if (a.alpha > 0.f) {
      const float w = a.alpha * T;
      cr += w * f[6 * K + k];
      cg += w * f[7 * K + k];
      cb += w * f[8 * K + k];
      cd += w * f[9 * K + k];
      ca += w;
      T *= 1.f - a.alpha;
    }
  }
  float* o = out + (size_t)ti * 8 * PX + tid;
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
    composite_fields_bwd_kernel(const float* __restrict__ origins,
                                const float* __restrict__ fields,
                                const float* __restrict__ cot, float* __restrict__ grad, int K,
                                float alpha_min, float alpha_max) {
  extern __shared__ float smem[];
  const int nsb = (K + SB - 1) / SB;
  float* f = smem;                 // NROWS * K
  float* tsb = f + NROWS * K;      // nsb * PX: T at each sub-block's start
  float* tk = tsb + nsb * PX;      // SB * PX: T before each candidate of one sub-block
  float* red = tk + SB * PX;       // WARPS * NGRAD * SB
  const int ti = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* src = fields + (size_t)ti * NFIELD * K;
  for (int i = tid; i < NROWS * K; i += PX) f[i] = src[i];
  const float gx = (float)(tid % TILE) + origins[2 * ti];
  const float gy = (float)(tid / TILE) + origins[2 * ti + 1];
  __syncthreads();

  // pass 1: forward, keeping T at each sub-block's start
  float T = 1.f;
  for (int s = 0; s < nsb; ++s) {
    tsb[s * PX + tid] = T;
    const int k1 = min(K, (s + 1) * SB);
    for (int k = s * SB; k < k1; ++k) {
      const Alpha a = cand_alpha(f, K, k, gx, gy, alpha_min, alpha_max);
      if (a.alpha > 0.f) T *= 1.f - a.alpha;
    }
  }
  const float* g = cot + (size_t)ti * 8 * PX + tid;
  // r, g, b, alpha, depth and g_T * T_final
  const float gv[6] = {g[0], g[PX], g[2 * PX], g[3 * PX], g[4 * PX], g[5 * PX] * T};
  float* dst = grad + (size_t)ti * NFIELD * K;

  // pass 2: sub-blocks back to front
  float S = 0.f;
  for (int s = nsb - 1; s >= 0; --s) {
    const int k0 = s * SB, n = min(K, k0 + SB) - k0;
    float t = tsb[s * PX + tid];
    for (int j = 0; j < n; ++j) {  // T before each candidate
      tk[j * PX + tid] = t;
      const Alpha a = cand_alpha(f, K, k0 + j, gx, gy, alpha_min, alpha_max);
      if (a.alpha > 0.f) t *= 1.f - a.alpha;
    }
    for (int j = n - 1; j >= 0; --j) {
      float c[NGRAD];
      const bool live = cand_grads(true, f, K, k0 + j, gx, gy, alpha_min, alpha_max,
                                   tk[j * PX + tid], gv, S, c);
      warp_sum(c, live);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < NGRAD; ++r) red[(warp * NGRAD + r) * SB + j] = c[r];
      }
    }
    __syncthreads();
    for (int i = tid; i < NGRAD * n; i += PX) {
      const int r = i / n, j = i % n;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += red[(w * NGRAD + r) * SB + j];
      dst[r * K + k0 + j] = sum;
    }
    __syncthreads();  // red and tk are reused by the next sub-block
  }
  for (int i = tid; i < (NFIELD - NGRAD) * K; i += PX) dst[NGRAD * K + i] = 0.f;
}

size_t fwd_smem(int K) { return (size_t)NROWS * K * sizeof(float); }

size_t bwd_smem(int K) {
  const size_t nsb = (K + SB - 1) / SB;
  return ((size_t)NROWS * K + nsb * PX + (size_t)SB * PX + (size_t)WARPS * NGRAD * SB) *
         sizeof(float);
}

int check_shape(int t, int K) {
  if (t <= 0 || K <= 0 || K > MAX_K) return (int)cudaErrorInvalidValue;
  if (K > KB && K % KB != 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// planes (T, 8, 256) from origins (T, 2) and fields (T, 12, K), all f32 and
// contiguous; K <= 128, or a multiple of 128 up to 1024.
extern "C" int composite_fields_fwd(const void* origins, const void* fields, void* out, int t,
                                    int K, float alpha_min, float alpha_max, void* stream) {
  int bad = check_shape(t, K);
  if (bad) return bad;
  const size_t smem = fwd_smem(K);
  cudaError_t err = cudaFuncSetAttribute(composite_fields_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_fields_fwd_kernel<<<t, PX, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origins), static_cast<const float*>(fields),
      static_cast<float*>(out), K, alpha_min, alpha_max);
  return (int)cudaGetLastError();
}

// grad (T, 12, K): rows 0-9 the field gradients, rows 10-11 zero, from the
// forward's inputs and the planes' cotangent cot (T, 8, 256).
extern "C" int composite_fields_bwd(const void* origins, const void* fields, const void* cot,
                                    void* grad, int t, int K, float alpha_min,
                                    float alpha_max, void* stream) {
  int bad = check_shape(t, K);
  if (bad) return bad;
  const size_t smem = bwd_smem(K);
  cudaError_t err = cudaFuncSetAttribute(composite_fields_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_fields_bwd_kernel<<<t, PX, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origins), static_cast<const float*>(fields),
      static_cast<const float*>(cot), static_cast<float*>(grad), K, alpha_min, alpha_max);
  return (int)cudaGetLastError();
}

extern "C" const char* composite_fields_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
