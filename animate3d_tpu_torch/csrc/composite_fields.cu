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
// one CTA of 256 threads owns one tile and keeps its fields (rows 0-10,
// 16-byte loads all in flight: load_rows) in shared memory (11 KB at K =
// 256). Both directions first cull exactly: each candidate is tested once
// for the tile (rect_dead, composite_common.cuh): not ok, opacity under
// alpha_min, or a positive-definite conic whose largest power over the
// tile's pixel rectangle lies under log(alpha_min / opacity) less a
// margin; such a candidate is provably not live at any pixel. The others
// are listed front to back by ballot and prefix (build_list), and each
// warp marks, per sub-block of SB = 32 listed candidates, those that can
// be live at its own 16 x 2 pixels (the same test on its rectangle, one
// bit a candidate). On the recon asset at 64^2, where 0.5% of the (pixel,
// candidate) pairs are live, a tile lists 40 of its 256 candidates on
// average and a warp marks 9; the densest warp of the 8-render bucket
// marks 133 (squarer 8 x 4 blocks mark 6.4 on average but 156 at the
// densest warp, which sets a small grid's time: PERF.md). A candidate that
// is not walked for a pixel is not live there, and every walked one goes
// through the float operations of the walk over all K candidates in the
// same order, so planes and gradient are the bits of that walk. Each walk
// takes two candidates a step: their alphas are independent chains that
// overlap, while T (and S) take them in turn.
//   forward: the tile's pass keeps each listed candidate's CullBound (its
//     lambda_min and threshold, in double), so a warp's marks need no
//     square root, division or log; the listed candidates are copied in
//     list order as 48-byte records (three 16-byte loads a candidate in
//     the walk, no index to follow: H's forward does the same); then one
//     pass over the warp's marked candidates, marking each sub-block as it
//     goes. 28 KB of shared memory at K = 256.
//   backward: the CTA writes its tile's (12, K) gradient block once: no
//     atomics, the result is deterministic; the unlisted candidates' rows
//     are zero. (1) A forward pass over the warp's marked candidates keeps
//     each pixel's transmittance at the start of every sub-block (shared
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
//     candidates zero. 63 KB of shared memory at K = 256: three CTAs an SM.
//
// Bound on the H100: the culled pairs are provably dead, so each direction
// owes the kept ones: 14 f32 operations a kept (pixel, candidate) pair, 12
// more forward / 40 backward where alpha is live, and the cull tests in
// f64; the bytes are the fields read once and the planes (and gradient)
// written once. What holds both is a grid of one CTA a tile, whose time at
// a small grid is that of its densest warp's walk (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace composite;

constexpr int NROWS = 11;  // rows read by the kernels: 0-10
constexpr int SB = 32;     // listed candidates a sub-block: one warp ballot of marks
constexpr int MAX_K = 1024;

// Rows 0-10 of one tile's fields (src, rows of K) into shared memory f4:
// 16-byte loads, all in flight together, where K % 4 == 0 (loading 4 a
// thread at a time cost the backward 4-5%: PERF.md).
__device__ __forceinline__ void load_rows(float4* f4, const float* src, int K, int tid) {
  if (K % 4 == 0) {
    constexpr int MAXV = (NROWS * MAX_K / 4 + PX - 1) / PX;
    const int n4 = NROWS * K / 4;
    float4 v[MAXV];
#pragma unroll
    for (int i = 0; i < MAXV; ++i)
      if (tid + i * PX < n4) v[i] = reinterpret_cast<const float4*>(src)[tid + i * PX];
#pragma unroll
    for (int i = 0; i < MAXV; ++i)
      if (tid + i * PX < n4) f4[tid + i * PX] = v[i];
  } else {
    float* f = reinterpret_cast<float*>(f4);
    for (int i = tid; i < NROWS * K; i += PX) f[i] = src[i];
  }
}

// Candidate j's record: its fields, rows 0-10 and a zero, as 12 floats.
__device__ __forceinline__ void load_record(const float4* rec, int j, float (&c)[NFIELD]) {
#pragma unroll
  for (int q = 0; q < NFIELD / 4; ++q) {
    const float4 x = rec[j * (NFIELD / 4) + q];
    c[4 * q] = x.x;
    c[4 * q + 1] = x.y;
    c[4 * q + 2] = x.z;
    c[4 * q + 3] = x.w;
  }
}

__global__ void __launch_bounds__(PX)
    composite_fields_fwd_kernel(const float* __restrict__ origins,
                                const float* __restrict__ fields, float* __restrict__ out,
                                int K, float alpha_min, float alpha_max) {
  extern __shared__ float4 smem4[];
  const int ngrp = (K + 31) / 32;
  float4* rec = smem4;  // K * 3: the listed candidates' records, list order
  CullBound* bnd = reinterpret_cast<CullBound*>(rec + 3 * K);  // K: by candidate
  float4* f4 = reinterpret_cast<float4*>(bnd + K);             // NROWS * K floats
  const float* f = reinterpret_cast<const float*>(f4);
  int* hl = reinterpret_cast<int*>(f4) + NROWS * K;       // K: the tile's list
  unsigned* gbal = reinterpret_cast<unsigned*>(hl + K);  // ngrp: listed bits
  int* gpre = reinterpret_cast<int*>(gbal + ngrp);       // ngrp + 1
  const int ti = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_rows(f4, fields + (size_t)ti * NFIELD * K, K, tid);
  const float tx0 = origins[2 * ti], ty0 = origins[2 * ti + 1];
  const float gx = (float)(tid % TILE) + tx0;
  const float gy = (float)(tid / TILE) + ty0;
  __syncthreads();
  // the candidates that can be live somewhere in the tile, front to back,
  // each with its CullBound for the warps' marks
  build_list(
      K,
      [&](int k) {
        CullBound cb;
        if (cull_bound(f, K, k, alpha_min, cb) || rect_beyond(cb, f, K, k, tx0, ty0, TILE, TILE))
          return false;
        bnd[k] = cb;
        return true;
      },
      hl, gbal, gpre);
  const int n = gpre[ngrp];
  for (int i = tid; i < n * NFIELD; i += PX) {
    const int j = i / NFIELD, r = i - j * NFIELD;
    reinterpret_cast<float*>(rec)[i] = r < NROWS ? f[r * K + hl[j]] : 0.f;
  }
  __syncthreads();
  const float wy0 = ty0 + (float)(2 * warp);

  float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, cd = 0.f, ca = 0.f;
  // a candidate at this pixel: the float operations of the walk over all K
  // candidates, in its order
  auto add = [&](const Alpha& a, const float (&c)[NFIELD]) {
    if (a.alpha > 0.f) {
      const float w = a.alpha * T;
      cr += w * c[6];
      cg += w * c[7];
      cb += w * c[8];
      cd += w * c[9];
      ca += w;
      T *= 1.f - a.alpha;
    }
  };
  // each 32 listed candidates: this warp's marks (the bound of each from
  // the tile's pass), then the marked ones front to back, two a step:
  // their alphas are independent; T and the sums take them in turn
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    unsigned mk = __ballot_sync(
        0xffffffffu, j < n && !rect_beyond(bnd[hl[j]], f, K, hl[j], tx0, wy0, TILE, 2));
    while (mk) {
      const int ja = __ffs(mk) - 1;
      mk &= mk - 1;
      const bool two = mk != 0;
      const int jb = two ? __ffs(mk) - 1 : ja;
      mk &= mk - 1;
      float c0[NFIELD], c1[NFIELD];
      load_record(rec, j0 + ja, c0);
      load_record(rec, j0 + jb, c1);
      const Alpha aa = cand_alpha(c0, 1, 0, gx, gy, alpha_min, alpha_max);
      const Alpha ab = cand_alpha(c1, 1, 0, gx, gy, alpha_min, alpha_max);
      add(aa, c0);
      if (two) add(ab, c1);
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
  load_rows(smem4, fields + (size_t)ti * NFIELD * K, K, tid);
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

size_t fwd_smem(int K) {
  const size_t ngrp = (K + 31) / 32;
  return (size_t)K * (NFIELD + NROWS) * sizeof(float) + (size_t)K * sizeof(CullBound) +
         (K + 2 * ngrp + 1) * sizeof(int);
}

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
