// Packed tiny-sequence self-attention for Hopper (sm_90a), bf16 in/out.
//
// Replaces: animate3d_tpu/ops/attention.py::_packed_padded_kernel, reached
// through packed_temporal_flash_padded (the motion modules' temporal
// attention: thousands of independent 16-frame sequences), and
// animate3d_tpu/ops/attention.py::_packed_temporal_kernel (kernel F, the same
// function in the unpadded layout, reached under attention_backend
// "packed_flash" at every head width the motion modules use: 40, 80, 160).
//
// Computes, for each sequence of S tokens and each head, softmax(q k^T *
// scale) v with the TPU kernel's numerics: the scale is applied after the
// QK^T dot in f32, the softmax runs in exp2 form, and P is normalised BEFORE
// its bf16 cast for the PV product (unlike the flash kernel, which divides
// after PV). q/k/v/out are the merged (B, S, H*D) layout; heads are read by
// stride, nothing is padded to 128 tokens or lanes.
//
// Bound on the H100: memory. The work is 4*S*D flops per token and head
// against 8*D bytes moved (q, k, v read, out written), about S/2 flops per
// byte, far below the ~295 at which the tensor cores would bind. Design:
// one CTA owns a tile of 16 (S <= 16) or 32 (S = 32) consecutive tokens,
// i.e. whole sequences, across ALL heads, so its q/k/v loads are whole
// contiguous (tile, H*D) rows, coalesced 16-byte loads into shared memory.
// Each warp takes a head at a time: the (tile x tile) score block is one or
// four bf16 WMMA products, masked to its sequences' block diagonal, the
// softmax runs in registers, and PV is a second WMMA product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <int TS, int DP>
__host__ __device__ constexpr size_t warp_bytes() {
  return (size_t)TS * TS * (sizeof(float) + sizeof(bf16)) + (size_t)TS * DP * sizeof(float);
}

template <int TS, int DP>
size_t smem_bytes(int H) {
  return 3 * (size_t)H * TS * DP * sizeof(bf16) + WARPS * warp_bytes<TS, DP>();
}

template <int TS, int DP>
__global__ void __launch_bounds__(THREADS)
packed_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int T,
                   int S, int H, int D, long long q_ld, long long k_ld,
                   long long v_ld, long long o_ld, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HT = H * TS * DP;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + HT;
  bf16* sV = sK + HT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wbase = reinterpret_cast<unsigned char*>(sV + HT) + warp * warp_bytes<TS, DP>();
  float* sSw = reinterpret_cast<float*>(wbase);
  bf16* sPw = reinterpret_cast<bf16*>(sSw + TS * TS);
  float* sOw = reinterpret_cast<float*>(sPw + TS * TS);

  const int t0 = blockIdx.x * TS;
  constexpr int CH = DP / 8;
  const int dch = D / 8;
  for (int i = threadIdx.x; i < TS * H * CH; i += THREADS) {
    const int rr = i / (H * CH), rem = i - rr * H * CH;
    const int hh = rem / CH, c = rem - hh * CH;
    const int t = t0 + rr;
    uint4 zq = make_uint4(0u, 0u, 0u, 0u), zk = zq, zv = zq;
    if (t < T && c < dch) {
      const long long col = (long long)hh * D + c * 8;
      zq = *reinterpret_cast<const uint4*>(q + t * q_ld + col);
      zk = *reinterpret_cast<const uint4*>(k + t * k_ld + col);
      zv = *reinterpret_cast<const uint4*>(v + t * v_ld + col);
    }
    const int dst = (hh * TS + rr) * DP + c * 8;
    *reinterpret_cast<uint4*>(sQ + dst) = zq;
    *reinterpret_cast<uint4*>(sK + dst) = zk;
    *reinterpret_cast<uint4*>(sV + dst) = zv;
  }
  __syncthreads();

  constexpr int LPR = 32 / TS;   // lanes per score row: 2 (TS=16) or 1 (TS=32)
  constexpr int CPL = TS / LPR;  // score columns per lane
  const int r = lane / LPR, c0 = (lane % LPR) * CPL;
  const int HD = D / 2;

  for (int hh = warp; hh < H; hh += WARPS) {
    const bf16* qh = sQ + hh * TS * DP;
    const bf16* kh = sK + hh * TS * DP;
    const bf16* vh = sV + hh * TS * DP;

#pragma unroll
    for (int i = 0; i < TS / 16; ++i) {
#pragma unroll
      for (int j = 0; j < TS / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
          wmma::load_matrix_sync(af, qh + i * 16 * DP + kk * 16, DP);
          wmma::load_matrix_sync(bf, kh + j * 16 * DP + kk * 16, DP);
          wmma::mma_sync(acc, af, bf, acc);
        }
        wmma::store_matrix_sync(sSw + i * 16 * TS + j * 16, acc, TS, wmma::mem_row_major);
      }
    }
    __syncwarp();

    float sv[CPL];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = c0 + c;
      const float s = sSw[r * TS + col] * scale_log2 + ((r / S) == (col / S) ? 0.f : -1e30f);
      sv[c] = s;
      mx = fmaxf(mx, s);
    }
    if (LPR == 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      sv[c] = exp2f(sv[c] - mx);
      sum += sv[c];
    }
    if (LPR == 2) sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float l = fmaxf(sum, 1e-30f);
#pragma unroll
    for (int c = 0; c < CPL; ++c) sPw[r * TS + c0 + c] = __float2bfloat16(sv[c] / l);
    __syncwarp();

#pragma unroll
    for (int i = 0; i < TS / 16; ++i) {
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < TS / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(pf, sPw + i * 16 * TS + kk * 16, TS);
          wmma::load_matrix_sync(vf, vh + kk * 16 * DP + j * 16, DP);
          wmma::mma_sync(acc, pf, vf, acc);
        }
        wmma::store_matrix_sync(sOw + i * 16 * DP + j * 16, acc, DP, wmma::mem_row_major);
      }
    }
    __syncwarp();

    for (int idx = lane; idx < TS * HD; idx += 32) {
      const int rr = idx / HD, cp = (idx - rr * HD) * 2;
      const int t = t0 + rr;
      if (t < T)
        *reinterpret_cast<__nv_bfloat162*>(out + t * o_ld + (long long)hh * D + cp) =
            __floats2bfloat162_rn(sOw[rr * DP + cp], sOw[rr * DP + cp + 1]);
    }
    __syncwarp();  // the next head reuses this warp's scratch
  }
}

template <int TS, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int H, int D, long long q_ld, long long k_ld, long long v_ld,
           long long o_ld, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<TS, DP>(H);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(packed_attn_kernel<TS, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int T = B * S;
  packed_attn_kernel<TS, DP><<<(T + TS - 1) / TS, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), T, S, H, D, q_ld,
      k_ld, v_ld, o_ld, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out: (B, S, H*D) bf16 with token stride *_ld (elements); S in
// {2, 4, 8, 16, 32}; D a multiple of 8 with D <= 48 or 64 < D <= 80, or
// 144 < D <= 160 at S <= 16 (the 160-wide heads of the 1280-channel
// motion modules; a 32-token tile of them is over the shared memory).
extern "C" int packed_attn(const void* q, const void* k, const void* v, void* out,
                           int B, int S, int H, int D, long long q_ld,
                           long long k_ld, long long v_ld, long long o_ld,
                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DP = (D + 15) / 16 * 16;
  if (S == 2 || S == 4 || S == 8 || S == 16) {
    if (DP == 48) return launch<16, 48>(q, k, v, out, B, S, H, D, q_ld, k_ld, v_ld, o_ld, scale, s);
    if (DP == 80) return launch<16, 80>(q, k, v, out, B, S, H, D, q_ld, k_ld, v_ld, o_ld, scale, s);
    if (DP == 160) return launch<16, 160>(q, k, v, out, B, S, H, D, q_ld, k_ld, v_ld, o_ld, scale, s);
  } else if (S == 32) {
    if (DP == 48) return launch<32, 48>(q, k, v, out, B, S, H, D, q_ld, k_ld, v_ld, o_ld, scale, s);
    if (DP == 80) return launch<32, 80>(q, k, v, out, B, S, H, D, q_ld, k_ld, v_ld, o_ld, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* packed_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
