// Device code shared by the two gaussian compositing kernels, H
// (composite_coarse.cu) and G (composite_fields.cu): the per-pixel alpha of
// one candidate with its gates, one candidate's 10 field-gradient terms in
// the backward's reverse walk, the front-to-back list of a tile's
// candidates that pass a test (ballot and prefix), and the exact cull of a
// candidate for a tile or a warp's pixels from its conic (rect_dead, split
// into the candidate's own bound and its test on one rectangle).
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
// c (zero unless its alpha is live), from its Alpha a, made by cand_alpha
// at this pixel. t_k is the
// transmittance before k; S the suffix sum of dw * w over the later
// candidates, advanced here; g the pixel's cotangent (r, g, b, alpha, depth)
// and g_T * T_final. dalpha = dw T_k - (S + g_T T_final) / (1 - alpha); the
// gradient passes through alpha only where raw <= alpha_max. Returns
// whether the candidate is live.
__device__ __forceinline__ bool alpha_grads(const Alpha& a, const float* f, int kc, int k,
                                            float alpha_max, float t_k, const float* g,
                                            float& S, float* c) {
#pragma unroll
  for (int r = 0; r < NGRAD; ++r) c[r] = 0.f;
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

// The candidates k < kc for which keep(k) holds, front to back, in
// hl[0, n) (ballot + prefix); gbal[g] holds their bits in 32-candidate
// group g, gpre[g] counts those before group g, gpre[ngrp] = n. kc <= 1024.
// Called by all PX threads; returns after a barrier, with hl, gbal and gpre
// visible to every thread.
template <class Keep>
__device__ __forceinline__ void build_list(int kc, Keep keep, int* hl, unsigned* gbal,
                                           int* gpre) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int ngrp = (kc + 31) / 32;  // <= 32
  for (int k0 = 0; k0 < kc; k0 += PX) {
    const int k = k0 + tid;
    const unsigned bal = __ballot_sync(0xffffffffu, k < kc && keep(k));
    if (lane == 0 && k < kc) gbal[k >> 5] = bal;
  }
  __syncthreads();
  if (tid < 32) {
    const int c = tid < ngrp ? __popc(gbal[tid]) : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    if (tid < ngrp) gpre[tid] = incl - c;
    if (tid == 31) gpre[ngrp] = incl;
  }
  __syncthreads();
  for (int k = tid; k < kc; k += PX) {
    const unsigned bal = gbal[k >> 5];
    if ((bal >> (k & 31)) & 1u) hl[gpre[k >> 5] + __popc(bal & ((1u << (k & 31)) - 1u))] = k;
  }
  __syncthreads();
}

// Margin under log(alpha_min / opacity) of the power bounds that drop a
// candidate (H's warp skip, the per-tile cull): far above the rounding of
// logf, expf and the product o e.
constexpr float SKIP_MARGIN = 1e-3f;

// What of rect_dead's test depends on candidate k alone: lmin (below) and
// thr = log(alpha_min / opacity) - SKIP_MARGIN, or thr = -inf where no
// rectangle can drop the candidate (alpha_min <= 0, a conic that is not
// positive definite, anything NaN).
struct CullBound {
  double lmin, thr;
};

// Whether candidate k is dead at every pixel (ok <= 0, or opacity under
// alpha_min > 0); else its CullBound in cb.
__device__ __forceinline__ bool cull_bound(const float* f, int kc, int k, float alpha_min,
                                           CullBound& cb) {
  cb.lmin = 0.0;
  cb.thr = -INFINITY;
  if (!(f[10 * kc + k] > 0.f)) return true;
  if (!(alpha_min > 0.f)) return false;
  const float o = f[5 * kc + k];
  if (o < alpha_min) return true;
  const double a = f[2 * kc + k], b = f[3 * kc + k], c = f[4 * kc + k];
  const double det = a * c - b * b;
  if (!(a > 0.0 && c > 0.0 && det > 0.0)) return false;
  const double lmax = 0.5 * (a + c) + sqrt(0.25 * (a - c) * (a - c) + b * b);
  cb.lmin = det / lmax * (1.0 - 1e-9);
  cb.thr = (double)logf(alpha_min / o) - (double)SKIP_MARGIN;
  return false;
}

// Whether candidate k, of CullBound cb, is not live at any pixel centre
// (x0 + 0 .. nx - 1, y0 + 0 .. ny - 1) of a rectangle: its largest power
// there, bounded by -1/2 lmin dist^2 (dist: from the candidate's centre to
// the rectangle) plus a bound on the float evaluation's rounding (1e-5 of
// the terms' magnitudes, many times the few ulps of cand_power), lies
// under thr. False wherever thr is -inf, and where anything is NaN.
__device__ __forceinline__ bool rect_beyond(const CullBound& cb, const float* f, int kc, int k,
                                            float x0, float y0, int nx, int ny) {
  const double a = f[2 * kc + k], b = f[3 * kc + k], c = f[4 * kc + k];
  // dx = x - gx over gx in [x0, x0 + nx - 1]: [dx0, dx1]; dy likewise
  const double dx0 = (double)f[k] - ((double)x0 + (nx - 1)), dx1 = (double)f[k] - x0;
  const double dy0 = (double)f[kc + k] - ((double)y0 + (ny - 1)), dy1 = (double)f[kc + k] - y0;
  const double ex = dx0 > 0.0 ? dx0 : (dx1 < 0.0 ? -dx1 : 0.0);
  const double ey = dy0 > 0.0 ? dy0 : (dy1 < 0.0 ? -dy1 : 0.0);
  const double mx = fmax(fabs(dx0), fabs(dx1)), my = fmax(fabs(dy0), fabs(dy1));
  const double err = 1e-5 * (a * mx * mx + c * my * my + 2.0 * fabs(b) * mx * my);
  const double pmax = -0.5 * cb.lmin * (ex * ex + ey * ey) + err;
  return pmax < cb.thr;
}

// Whether candidate k's alpha is provably under alpha_min (so not live) at
// every pixel centre of a rectangle (a tile, or a warp's pixels):
//   * ok <= 0;
//   * or opacity < alpha_min (alpha_min > 0): where power <= 0, e <= 1, so
//     raw = o e <= o;
//   * or the conic (a, b, c) is positive definite and rect_beyond holds:
//     lambda_min = det / lambda_max in double (a c and b^2 exact there),
//     shaded down by 1e-9, and the threshold log(alpha_min / opacity) less
//     SKIP_MARGIN.
// A conic that is not positive definite, and anything NaN, is kept.
__device__ __forceinline__ bool rect_dead(const float* f, int kc, int k, float x0, float y0,
                                          int nx, int ny, float alpha_min) {
  CullBound cb;
  return cull_bound(f, kc, k, alpha_min, cb) || rect_beyond(cb, f, kc, k, x0, y0, nx, ny);
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

// One level of spread_sum: lanes paired across the lane bit OFF halve
// their N slots; the lower lane keeps slots 0 .. H - 1, the upper lane the
// rest (moved down to slot 0), each slot summed with the partner's copy,
// own value first, as warp_sum adds.
template <int N, int OFF>
__device__ __forceinline__ void spread_level(float* c, int lane) {
  constexpr int H = (N + 1) / 2;
  const bool up = lane & OFF;
#pragma unroll
  for (int t = 0; t < H; ++t) {
    const float hi = H + t < N ? c[H + t] : 0.f;
    const float got = __shfl_xor_sync(0xffffffffu, up ? c[t] : hi, OFF);
    c[t] = (up ? hi : c[t]) + got;
  }
}

// warp_sum's NGRAD sums with 12 shuffles in place of 50, each ending in
// one lane's c[0] (spread_term): the same pairs are added in the same tree
// (lanes 16 apart, then 8, 4, 2, 1, and a + b == b + a), so every sum is
// the same bits. Every lane must call it; like warp_sum it may be skipped
// where the warp has no live lane (c is zero there).
__device__ __forceinline__ void spread_sum(float* c, int lane) {
  static_assert(NGRAD == 10, "the levels below split 10 slots");
  spread_level<10, 16>(c, lane);
  spread_level<5, 8>(c, lane);
  spread_level<3, 4>(c, lane);
  spread_level<2, 2>(c, lane);
  spread_level<1, 1>(c, lane);
}

// The term whose sum spread_sum leaves in this lane's c[0], or -1: slot 0
// of an even lane holds term 5 b4 + 3 b3 + 2 b2 + b1.
__device__ __forceinline__ int spread_term(int lane) {
  const int b1 = (lane >> 1) & 1, b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1;
  const int s2 = 2 * b2 + b1;
  if ((lane & 1) || s2 > 2 - b3) return -1;
  return 5 * (lane >> 4) + 3 * b3 + s2;
}

}  // namespace composite
