// Backward of the packed tiny-sequence self-attention for Hopper (sm_90a).
//
// Replaces: animate3d_tpu/ops/attention.py::_packed_padded_bwd_kernel,
// reached through packed_temporal_flash_padded's VJP (the motion modules'
// temporal attention: thousands of independent 16-frame sequences).
//
// For each sequence and head, with the TPU kernel's rounding points: the
// normalised P = softmax(q k^T * scale) in f32 (scale after the dot, exp2
// form, row sum floored at 1e-30), P_bf16 = bf16(P), o = P_bf16 v recomputed
// in f32, Delta = rowsum(g o) from that recomputed o (not from the stored
// bf16 output), dS = bf16(P (g v^T - Delta)), and
//   dq = dS k * scale,   dk = dS^T q * scale,   dv = P_bf16^T g.
// The cotangent g arrives already in q's dtype, as the TPU route downcasts
// it before its kernel. Layout: the merged (B, S, H*D) q/k/v/g; heads are
// read by stride, nothing is padded to 128 tokens or lanes.
//
// Bound on the H100: memory. Per token and head it moves 7*D*2 bytes (q, k,
// v, g read; dq, dk, dv written) against about 10*S*D flops, ~S/1.4 flops
// per byte, far below the ~295 where the tensor cores bind. Design: one CTA
// owns a tile of 16 (S <= 16) or 32 (S = 32) consecutive tokens, i.e. whole
// sequences, across all heads, so nothing is summed across CTAs. Each of
// its 4 warps takes a head at a time: it stages that head's q/k/v/g rows in
// its own shared memory, and every product is a bf16 WMMA tile (16x16 for
// S <= 16) with f32 accumulation: S and dP through a (tile x tile) f32
// scratch, P and dS as bf16 tiles, o and the three gradients through one
// (tile x D) f32 scratch before their bf16 stores. Sequences shorter than
// the tile (S < 16) are masked to the block diagonal as in the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// per-warp shared memory: q, k, v, g (TS x DP bf16 each), the S / dP
// scratch (TS x TS f32), P and dS (TS x TS bf16 each), the o / gradient
// scratch (TS x DP f32); every piece a multiple of 32 bytes (WMMA alignment)
template <int TS, int DP>
__host__ __device__ constexpr size_t warp_bytes() {
  return 4 * (size_t)TS * DP * sizeof(bf16) + (size_t)TS * TS * sizeof(float) +
         2 * (size_t)TS * TS * sizeof(bf16) + (size_t)TS * DP * sizeof(float);
}

// c (M x N f32, row-major, ldc) = A (M x K) B (K x N) on the tensor cores.
// A is the row-major array a (lda) or, with TA, the transpose of the
// row-major (K x M) array a; B likewise with TB.
template <int M, int N, int K, bool TA, bool TB>
__device__ __forceinline__ void warp_mm(float* c, int ldc, const bf16* a, int lda,
                                        const bf16* b, int ldb) {
  using LA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
#pragma unroll
  for (int i = 0; i < M / 16; ++i) {
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> bf;
        wmma::load_matrix_sync(af, TA ? a + kk * 16 * lda + i * 16 : a + i * 16 * lda + kk * 16,
                               lda);
        wmma::load_matrix_sync(bf, TB ? b + j * 16 * ldb + kk * 16 : b + kk * 16 * ldb + j * 16,
                               ldb);
        wmma::mma_sync(acc, af, bf, acc);
      }
      wmma::store_matrix_sync(c + i * 16 * ldc + j * 16, acc, ldc, wmma::mem_row_major);
    }
  }
}

// rows of the (TS x DP) f32 scratch, times `mul`, to head hh of out (bf16)
template <int TS, int DP>
__device__ __forceinline__ void store_head(bf16* __restrict__ out, long long ld,
                                           const float* s, float mul, int t0, int T, int hh,
                                           int D, int lane) {
  const int HD = D / 2;
  for (int idx = lane; idx < TS * HD; idx += 32) {
    const int rr = idx / HD, cp = (idx - rr * HD) * 2;
    const int t = t0 + rr;
    if (t < T)
      *reinterpret_cast<__nv_bfloat162*>(out + t * ld + (long long)hh * D + cp) =
          __floats2bfloat162_rn(s[rr * DP + cp] * mul, s[rr * DP + cp + 1] * mul);
  }
}

template <int TS, int DP>
__global__ void __launch_bounds__(THREADS)
packed_attn_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                       int T, int S, int H, int D, long long q_ld, long long k_ld,
                       long long v_ld, long long g_ld, long long d_ld, float scale,
                       float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* sQ = reinterpret_cast<bf16*>(smem + warp * warp_bytes<TS, DP>());
  bf16* sK = sQ + TS * DP;
  bf16* sV = sK + TS * DP;
  bf16* sG = sV + TS * DP;
  float* sS = reinterpret_cast<float*>(sG + TS * DP);  // S, then dP
  bf16* sP = reinterpret_cast<bf16*>(sS + TS * TS);
  bf16* sdS = sP + TS * TS;
  float* sO = reinterpret_cast<float*>(sdS + TS * TS);  // o, then dq, dk, dv

  const int t0 = blockIdx.x * TS;
  constexpr int CH = DP / 8;
  const int dch = D / 8;
  constexpr int LPR = 32 / TS;   // lanes per score row: 2 (TS=16) or 1 (TS=32)
  constexpr int CPL = TS / LPR;  // score columns per lane
  const int r = lane / LPR, c0 = (lane % LPR) * CPL;

  for (int hh = warp; hh < H; hh += WARPS) {
    // this head's rows, zero past T and in the padded columns
    for (int i = lane; i < TS * CH; i += 32) {
      const int rr = i / CH, c = i - rr * CH;
      const int t = t0 + rr;
      uint4 zq = make_uint4(0u, 0u, 0u, 0u), zk = zq, zv = zq, zg = zq;
      if (t < T && c < dch) {
        const long long col = (long long)hh * D + c * 8;
        zq = *reinterpret_cast<const uint4*>(q + t * q_ld + col);
        zk = *reinterpret_cast<const uint4*>(k + t * k_ld + col);
        zv = *reinterpret_cast<const uint4*>(v + t * v_ld + col);
        zg = *reinterpret_cast<const uint4*>(g + t * g_ld + col);
      }
      const int dst = rr * DP + c * 8;
      *reinterpret_cast<uint4*>(sQ + dst) = zq;
      *reinterpret_cast<uint4*>(sK + dst) = zk;
      *reinterpret_cast<uint4*>(sV + dst) = zv;
      *reinterpret_cast<uint4*>(sG + dst) = zg;
    }
    __syncwarp();

    warp_mm<TS, TS, DP, false, true>(sS, TS, sQ, DP, sK, DP);  // S = q k^T
    __syncwarp();

    // normalised P in f32 (kept in registers) and its bf16 copy
    float pv[CPL];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = c0 + c;
      pv[c] = sS[r * TS + col] * scale_log2 + ((r / S) == (col / S) ? 0.f : -1e30f);
      mx = fmaxf(mx, pv[c]);
    }
    if (LPR == 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      pv[c] = exp2f(pv[c] - mx);
      sum += pv[c];
    }
    if (LPR == 2) sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float l = fmaxf(sum, 1e-30f);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      pv[c] = pv[c] / l;
      sP[r * TS + c0 + c] = __float2bfloat16(pv[c]);
    }
    __syncwarp();

    warp_mm<TS, DP, TS, false, false>(sO, DP, sP, TS, sV, DP);  // o = P_bf16 v
    warp_mm<TS, TS, DP, false, true>(sS, TS, sG, DP, sV, DP);   // dP = g v^T
    __syncwarp();

    // Delta = rowsum(g o) (the LPR lanes of a row split its columns)
    float delta = 0.f;
    for (int d = lane % LPR; d < DP; d += LPR)
      delta += __bfloat162float(sG[r * DP + d]) * sO[r * DP + d];
    if (LPR == 2) delta += __shfl_xor_sync(0xffffffffu, delta, 1);
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      sdS[r * TS + c0 + c] = __float2bfloat16(pv[c] * (sS[r * TS + c0 + c] - delta));
    __syncwarp();

    warp_mm<TS, DP, TS, false, false>(sO, DP, sdS, TS, sK, DP);  // dq = dS k
    __syncwarp();
    store_head<TS, DP>(dq, d_ld, sO, scale, t0, T, hh, D, lane);
    __syncwarp();
    warp_mm<TS, DP, TS, true, false>(sO, DP, sdS, TS, sQ, DP);  // dk = dS^T q
    __syncwarp();
    store_head<TS, DP>(dk, d_ld, sO, scale, t0, T, hh, D, lane);
    __syncwarp();
    warp_mm<TS, DP, TS, true, false>(sO, DP, sP, TS, sG, DP);  // dv = P_bf16^T g
    __syncwarp();
    store_head<TS, DP>(dv, d_ld, sO, 1.f, t0, T, hh, D, lane);
    __syncwarp();  // the next head reuses this warp's scratch
  }
}

template <int TS, int DP>
int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, int B, int S, int H, int D, long long q_ld, long long k_ld, long long v_ld,
           long long g_ld, long long d_ld, float scale, cudaStream_t stream) {
  const size_t smem = WARPS * warp_bytes<TS, DP>();
  cudaError_t err = cudaFuncSetAttribute(packed_attn_bwd_kernel<TS, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int T = B * S;
  packed_attn_bwd_kernel<TS, DP><<<(T + TS - 1) / TS, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, S, H, D, q_ld, k_ld, v_ld, g_ld, d_ld, scale,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/g: (B, S, H*D) bf16 with token stride *_ld (elements); dq/dk/dv:
// (B, S, H*D) bf16 with token stride d_ld. S in {2, 4, 8, 16, 32}; D a
// multiple of 8 with D <= 48 or 64 < D <= 80, or 144 < D <= 160 at S <= 16
// (the backward of kernel F's route at the 160-wide heads).
extern "C" int packed_attn_bwd(const void* q, const void* k, const void* v, const void* g,
                               void* dq, void* dk, void* dv, int B, int S, int H, int D,
                               long long q_ld, long long k_ld, long long v_ld, long long g_ld,
                               long long d_ld, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DP = (D + 15) / 16 * 16;
#define A3D_LAUNCH(TS, DPC) \
  return launch<TS, DPC>(q, k, v, g, dq, dk, dv, B, S, H, D, q_ld, k_ld, v_ld, g_ld, d_ld, scale, s)
  if (S == 2 || S == 4 || S == 8 || S == 16) {
    if (DP == 48) A3D_LAUNCH(16, 48);
    if (DP == 80) A3D_LAUNCH(16, 80);
    if (DP == 160) A3D_LAUNCH(16, 160);
  } else if (S == 32) {
    if (DP == 48) A3D_LAUNCH(32, 48);
    if (DP == 80) A3D_LAUNCH(32, 80);
  }
#undef A3D_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* packed_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
