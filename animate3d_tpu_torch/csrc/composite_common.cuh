// Device code shared by the two gaussian compositing kernels, H
// (composite_coarse.cu) and G (composite_fields.cu): the per-pixel alpha of
// one candidate with its gates, and one candidate's 10 field-gradient terms
// in the backward's reverse walk.
//
// Candidate fields sit in shared memory as rows of stride kc: 0 x, 1 y,
// 2-4 conic (a, b, c), 5 opacity, 6-8 rgb, 9 depth, 10 ok. expf (not
// __expf) and round-to-nearest products without contraction keep the 1/255
// gate on the same side as the plain PyTorch versions'.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace composite {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // threads per CTA: one per pixel
constexpr int KB = 128;          // candidate block of the TPU kernels
constexpr int NFIELD = 12;
constexpr int WARPS = PX / 32;
constexpr int NGRAD = 10;

struct Alpha {
  float dx, dy, e, raw, alpha;  // alpha == 0 where not live
};

// power = -0.5 (a dx^2 + c dy^2) - b dx dy of candidate k at pixel (gx, gy),
// with its offsets dx, dy.
__device__ __forceinline__ float cand_power(const float* f, int kc, int k, float gx, float gy,
                                            float& dx, float& dy) {
  dx = __fsub_rn(f[k], gx);
  dy = __fsub_rn(f[kc + k], gy);
  const float ca = f[2 * kc + k], cb = f[3 * kc + k], cc = f[4 * kc + k];
  const float sq = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx), __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, sq), __fmul_rn(__fmul_rn(cb, dx), dy));
}

// alpha = min(alpha_max, o e^power), live where power <= 0, alpha >= alpha_min
// and ok > 0.
__device__ __forceinline__ Alpha cand_alpha(const float* f, int kc, int k, float gx,
                                            float gy, float alpha_min, float alpha_max) {
  Alpha a;
  const float power = cand_power(f, kc, k, gx, gy, a.dx, a.dy);
  a.e = expf(power);
  a.raw = __fmul_rn(f[5 * kc + k], a.e);
  const float alpha = fminf(alpha_max, a.raw);
  const bool live = power <= 0.f && alpha >= alpha_min && f[10 * kc + k] > 0.f;
  a.alpha = live ? alpha : 0.f;
  return a;
}

// Candidate k's 10 gradient terms at this pixel in the reverse walk, into
// c (zero unless ``gate`` holds and its alpha is live). t_k is the
// transmittance before k; S the suffix sum of dw * w over the later
// candidates, advanced here; g the pixel's cotangent (r, g, b, alpha, depth)
// and g_T * T_final. dalpha = dw T_k - (S + g_T T_final) / (1 - alpha); the
// gradient passes through alpha only where raw <= alpha_max. Returns
// whether the candidate is live.
__device__ __forceinline__ bool cand_grads(bool gate, const float* f, int kc, int k, float gx,
                                           float gy, float alpha_min, float alpha_max,
                                           float t_k, const float* g, float& S, float* c) {
#pragma unroll
  for (int r = 0; r < NGRAD; ++r) c[r] = 0.f;
  if (!gate) return false;
  const Alpha a = cand_alpha(f, kc, k, gx, gy, alpha_min, alpha_max);
  if (!(a.alpha > 0.f)) return false;
  const float w = a.alpha * t_k;
  const float dw = g[0] * f[6 * kc + k] + g[1] * f[7 * kc + k] + g[2] * f[8 * kc + k] +
                   g[4] * f[9 * kc + k] + g[3];
  const float dalpha = dw * t_k - (S + g[5]) / (1.f - a.alpha);
  S += dw * w;
  if (a.raw <= alpha_max) {
    const float dop = dalpha * a.e, dpow = dalpha * a.raw;
    const float fa = f[2 * kc + k], fb = f[3 * kc + k], fc = f[4 * kc + k];
    c[0] = dpow * (-fa * a.dx - fb * a.dy);
    c[1] = dpow * (-fc * a.dy - fb * a.dx);
    c[2] = dpow * (-0.5f * a.dx * a.dx);
    c[3] = dpow * (-a.dx * a.dy);
    c[4] = dpow * (-0.5f * a.dy * a.dy);
    c[5] = dop;
  }
  c[6] = w * g[0];
  c[7] = w * g[1];
  c[8] = w * g[2];
  c[9] = w * g[4];
  return true;
}

// Sums c over the warp's 32 pixels into every lane by shuffles, skipped
// (c stays zero) where no lane of the warp is live. Every lane must call it.
__device__ __forceinline__ void warp_sum(float* c, bool live) {
  if (__any_sync(0xffffffffu, live)) {
#pragma unroll
    for (int r = 0; r < NGRAD; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) c[r] += __shfl_xor_sync(0xffffffffu, c[r], off);
    }
  }
}

}  // namespace composite
