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
//     atomics, the result is deterministic. (0) Each candidate is tested
//     once for the tile (rect_dead, composite_common.cuh): not ok, opacity
//     under alpha_min, or a positive-definite conic whose largest power over
//     the tile's pixel rectangle lies under log(alpha_min / opacity) less a
//     margin; such a candidate is provably not live at any pixel, so its
//     gradient rows are zero. The others are listed front to back by
//     ballot and prefix (build_list), and each warp marks, per sub-block of
//     SB = 32 listed candidates, those that can be live at its own 16 x 2
//     pixels (rect_dead again, one bit a candidate). On the recon asset at 64^2,
//     where 0.5% of the (pixel, candidate) pairs are live, a tile lists 40
//     of its 256 candidates on average and a warp marks 9 (PERF.md).
//     (1) A forward pass over the warp's marked candidates keeps each
//     pixel's transmittance at the start of every sub-block (shared
//     memory), and T before every candidate of the last sub-block; (2) back
//     to front, each earlier sub-block's T before every marked candidate is
//     recomputed from its checkpoint into shared memory (32 x 256 f32 = 32
//     KB), so T_k needs no division by (1 - alpha), and a list of at most
//     32 candidates is evaluated twice, not three times; (3) the marked
//     candidates of the sub-block are walked back to front with the running
//     suffix S = sum of dw w over later candidates; each candidate's 10
//     gradient terms are summed over the warp (spread_sum: the butterfly's
//     pairs and tree in 12 shuffles, not 50) and across the 8 warps in
//     shared memory, in a fixed order, the terms of a warp's unmarked
//     candidates zero. Each pass takes two candidates a step: their alphas
//     (and their warp sums) are independent chains that overlap, while T
//     and S take them in turn, which matters where a tile's warps are few
//     (1.3x at 128 tiles). Every walked candidate goes through the float
//     operations of the parent design's walk over all K candidates, in the
//     same order, and a candidate that is not walked for a pixel is not
//     live there (it changed no T and no S, and its terms were zero): the
//     gradient is the same bits. 63 KB of shared memory at K = 256: three
//     CTAs an SM.
//
// Bound on the H100: the TPU kernel evaluates every (pixel, candidate)
// pair (about 14 f32 operations, plus 12 forward / 40 backward where alpha
// is live), so at the recon shapes the forward's least time for that work
// is set by the operations, not the bytes (fields read once, planes
// written once). The forward's walk is sequential per thread over all K
// candidates. The backward's culled pairs are provably dead, so it owes
// only the listed ones; what holds it is a grid of one CTA a tile, whose
// time at a small grid is that of its densest tile (PERF.md).

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

// T through the candidates of sub-block j0 whose bits mk holds, in order,
// two a step (their alphas are independent; T takes them in turn, so the
// float operations are those of a walk one at a time); with tk, T before
// each candidate j goes to tk[j * PX].
__device__ __forceinline__ float march(float t, unsigned mk, const float* f, int K,
                                       const int* hl, int j0, float gx, float gy,
                                       float alpha_min, float alpha_max, float* tk) {
  while (mk) {
    const int ja = __ffs(mk) - 1;
    mk &= mk - 1;
    const bool two = mk != 0;
    const int jb = two ? __ffs(mk) - 1 : ja;
    mk &= mk - 1;
    const Alpha aa = cand_alpha(f, K, hl[j0 + ja], gx, gy, alpha_min, alpha_max);
    const Alpha ab = cand_alpha(f, K, hl[j0 + jb], gx, gy, alpha_min, alpha_max);
    if (tk) tk[ja * PX] = t;
    if (aa.alpha > 0.f) t *= 1.f - aa.alpha;
    if (two) {
      if (tk) tk[jb * PX] = t;
      if (ab.alpha > 0.f) t *= 1.f - ab.alpha;
    }
  }
  return t;
}

__global__ void __launch_bounds__(PX)
    composite_fields_bwd_kernel(const float* __restrict__ origins,
                                const float* __restrict__ fields,
                                const float* __restrict__ cot, float* __restrict__ grad, int K,
                                float alpha_min, float alpha_max) {
  extern __shared__ float4 smem4[];
  const int ngrp = (K + 31) / 32, msb = (K + SB - 1) / SB;
  float* f = reinterpret_cast<float*>(smem4);  // NROWS * K
  float* tk = f + NROWS * K;        // SB * PX: T before each listed candidate of one sub-block
  float* red = tk + SB * PX;        // WARPS * NGRAD * SB
  float* tsb = red + WARPS * NGRAD * SB;  // msb * PX: T at each sub-block's start
  unsigned* wmask = reinterpret_cast<unsigned*>(tsb + msb * PX);  // WARPS * msb
  int* hl = reinterpret_cast<int*>(wmask + WARPS * msb);          // K: the tile's list
  unsigned* gbal = reinterpret_cast<unsigned*>(hl + K);           // ngrp: listed bits
  int* gpre = reinterpret_cast<int*>(gbal + ngrp);                // ngrp + 1
  const int ti = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* src = fields + (size_t)ti * NFIELD * K;
  if (K % 4 == 0) {  // rows 0-10 as 16-byte loads, all in flight together
    constexpr int MAXV = (NROWS * MAX_K / 4 + PX - 1) / PX;
    const int n4 = NROWS * K / 4;
    float4 v[MAXV];
#pragma unroll
    for (int i = 0; i < MAXV; ++i)
      if (tid + i * PX < n4) v[i] = reinterpret_cast<const float4*>(src)[tid + i * PX];
#pragma unroll
    for (int i = 0; i < MAXV; ++i)
      if (tid + i * PX < n4) smem4[tid + i * PX] = v[i];
  } else {
    for (int i = tid; i < NROWS * K; i += PX) f[i] = src[i];
  }
  const float tx0 = origins[2 * ti], ty0 = origins[2 * ti + 1];
  const float gx = (float)(tid % TILE) + tx0;
  const float gy = (float)(tid / TILE) + ty0;
  __syncthreads();

  // (0) the candidates that can be live somewhere in the tile, front to
  // back, then for each sub-block of the list the bits of those that can
  // be live at this warp's 16 x 2 pixels
  build_list(
      K, [&](int k) { return !rect_dead(f, K, k, tx0, ty0, TILE, TILE, alpha_min); }, hl,
      gbal, gpre);
  const int n = gpre[ngrp], nsb = (n + SB - 1) / SB;
  float* dst = grad + (size_t)ti * NFIELD * K;
  for (int i = tid; i < NGRAD * K; i += PX) {  // the unlisted candidates' rows are zero
    const int k = i % K;
    if (!((gbal[k >> 5] >> (k & 31)) & 1u)) dst[i] = 0.f;
  }
  for (int i = tid; i < (NFIELD - NGRAD) * K; i += PX) dst[NGRAD * K + i] = 0.f;
  const float wy0 = ty0 + (float)(2 * warp);
  for (int s = 0; s < nsb; ++s) {
    const int j = s * SB + lane;
    const unsigned m = __ballot_sync(
        0xffffffffu, j < n && !rect_dead(f, K, hl[j], tx0, wy0, TILE, 2, alpha_min));
    if (lane == 0) wmask[warp * msb + s] = m;
  }
  __syncwarp();

  // (1) forward over the warp's candidates, keeping T at each sub-block's
  // start, and T before each candidate of the last sub-block (walked first)
  float T = 1.f;
  for (int s = 0; s < nsb; ++s) {
    tsb[s * PX + tid] = T;
    T = march(T, wmask[warp * msb + s], f, K, hl, s * SB, gx, gy, alpha_min, alpha_max,
              s == nsb - 1 ? tk + tid : nullptr);
  }
  const float* g = cot + (size_t)ti * 8 * PX + tid;
  // r, g, b, alpha, depth and g_T * T_final
  const float gv[6] = {g[0], g[PX], g[2 * PX], g[3 * PX], g[4 * PX], g[5 * PX] * T};

  // (2), (3) sub-blocks back to front
  float S = 0.f;
  for (int s = nsb - 1; s >= 0; --s) {
    const int j0 = s * SB, m = min(n, j0 + SB) - j0;
    const unsigned wm = wmask[warp * msb + s];
    if (s < nsb - 1)  // T before each candidate, from the sub-block's checkpoint
      march(tsb[s * PX + tid], wm, f, K, hl, j0, gx, gy, alpha_min, alpha_max, tk + tid);
    // the terms of the candidates this warp cannot see are zero
    for (int i = lane; i < NGRAD * SB; i += 32) red[warp * NGRAD * SB + i] = 0.f;
    __syncwarp();
    const int r = spread_term(lane);
    for (unsigned mk = wm; mk;) {  // two a step, back to front, as march
      const int ja = 31 - __clz(mk);
      mk &= ~(1u << ja);
      const bool two = mk != 0;
      const int jb = two ? 31 - __clz(mk) : ja;
      if (two) mk &= ~(1u << jb);
      const int ka = hl[j0 + ja], kb = hl[j0 + jb];
      const Alpha aa = cand_alpha(f, K, ka, gx, gy, alpha_min, alpha_max);
      const Alpha ab = cand_alpha(f, K, kb, gx, gy, alpha_min, alpha_max);
      float ca[NGRAD], cb[NGRAD] = {};
      bool live = alpha_grads(aa, f, K, ka, alpha_max, tk[ja * PX + tid], gv, S, ca);
      if (two) live |= alpha_grads(ab, f, K, kb, alpha_max, tk[jb * PX + tid], gv, S, cb);
      if (__any_sync(0xffffffffu, live)) {  // a candidate with no live lane keeps zeros
        spread_sum(ca, lane);
        spread_sum(cb, lane);
      }
      if (r >= 0) {
        red[(warp * NGRAD + r) * SB + ja] = ca[0];
        if (two) red[(warp * NGRAD + r) * SB + jb] = cb[0];
      }
    }
    __syncthreads();
    for (int i = tid; i < NGRAD * m; i += PX) {
      const int r = i / m, j = i % m;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += red[(w * NGRAD + r) * SB + j];
      dst[r * K + hl[j0 + j]] = sum;
    }
    __syncthreads();  // red and tk are reused by the next sub-block
  }
}

size_t fwd_smem(int K) { return (size_t)NROWS * K * sizeof(float); }

size_t bwd_smem(int K) {
  const size_t msb = (K + SB - 1) / SB, ngrp = (K + 31) / 32;
  return ((size_t)NROWS * K + msb * PX + (size_t)SB * PX + (size_t)WARPS * NGRAD * SB) *
             sizeof(float) +
         ((size_t)WARPS * msb + K + 2 * ngrp + 1) * sizeof(int);
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
