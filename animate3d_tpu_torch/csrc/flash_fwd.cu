// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces: animate3d_tpu/ops/attention.py::_flash_kernel_wholek and
// _flash_kernel, reached through _flash_fwd_impl_merged /
// flash_attention_padded (the TPU's lane-padded merged-head route).
//
// Computes, per (batch, head), the non-causal unmasked attention
//   out = softmax(q k^T * scale) v,   lse = log(sum(exp(q k^T * scale)))
// reading q/k/v straight from the merged (B, S, H*D) layout by stride (no
// 128-lane head padding: D is padded to a multiple of 16 in shared memory
// only, 40 -> 48, 80 stays 80). K/V may be shared by `kv_group` consecutive
// query batches (the I2V branches' frame-0 K/V) through their batch index
// b / kv_group, so the broadcast is never materialised.
//
// Numerics follow the TPU kernel where that is cheap: f32 scores, exact
// online softmax in exp2 form (the SFU's ex2.approx), bf16 P in the PV
// product with f32 accumulation, division by the f32 row sum after PV, a
// 1e-30 floor on the row sum, lse in natural log. The TPU's skip-max clamp for Sk >= 2048 is
// not reproduced (it only differs once a base-2 logit passes 110).
//
// Bound on the H100: at the main-path shapes (S = 4096, D = 40 and
// S = 1024, D = 80) the 4*S*S*D flops per (batch, head) dwarf the bytes,
// so the tensor cores bound it. Design (FlashAttention-2 on mma.sync): one
// CTA of 4 warps owns a 64-row q tile of one (batch, head), each warp 16
// rows. K/V stream through a 2-stage cp.async ring of 64-key tiles in
// shared memory; QK^T and PV are bf16 m16n8k16 mma.sync with operands
// fetched by ldmatrix (V through its transposing form), and the scores,
// probabilities and running output never leave registers: the QK^T
// accumulators become PV's A operand in place. Not yet: wgmma, TMA, warp
// specialisation.

#include <math.h>

#include "mma_common.cuh"

namespace {

constexpr int BQ = 64;     // query rows per CTA
constexpr int BK = 64;     // keys per K/V tile
constexpr int WARPS = 4;   // 16 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float LN2 = 0.6931471805599453f;

template <int DP>
struct Cfg {
  static constexpr int LD = DP + 8;  // padded smem row: conflict-free ldmatrix
  static constexpr int TILE = 64 * LD;  // elements of one 64-row tile
  static constexpr size_t SMEM = (size_t)5 * TILE * sizeof(bf16);  // Q + 2x(K, V)
};

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Sk, int D,
                 long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                 long long v_bs, long long v_rs, long long o_bs, long long o_rs,
                 int kv_group, float scale_log2) {
  constexpr int LD = Cfg<DP>::LD;
  constexpr int KD = DP / 16;  // k-steps over the head dim
  constexpr int ND = DP / 8;   // 8-wide output column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK[2] = {sQ + Cfg<DP>::TILE, sQ + 3 * Cfg<DP>::TILE};
  bf16* sV[2] = {sQ + 2 * Cfg<DP>::TILE, sQ + 4 * Cfg<DP>::TILE};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + (long long)b * q_bs + (long long)h * D;
  const bf16* kb = k + (long long)(b / kv_group) * k_bs + (long long)h * D;
  const bf16* vb = v + (long long)(b / kv_group) * v_bs + (long long)h * D;
  const int ntiles = (Sk + BK - 1) / BK;

  load_tile<DP, Cfg<DP>::LD>(sQ, qb, q_rs, q0, Sq, D);
  load_tile<DP, Cfg<DP>::LD>(sK[0], kb, k_rs, 0, Sk, D);
  load_tile<DP, Cfg<DP>::LD>(sV[0], vb, v_rs, 0, Sk, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q A-fragments, kept in registers for every K/V tile
  unsigned qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their row sums

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      load_tile<DP, Cfg<DP>::LD>(sK[st ^ 1], kb, k_rs, (it + 1) * BK, Sk, D);
      load_tile<DP, Cfg<DP>::LD>(sV[st ^ 1], vb, v_rs, (it + 1) * BK, Sk, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK[st];
    const bf16* cV = sV[st];

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kf[4];
        const int mi = lane >> 3;
        ldmatrix_x4(kf, cK + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * LD + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // online softmax, base 2, on the raw scores (scale > 0 keeps the max):
    // p = 2^(s * scale_log2 - m) as one FMA + ex2; keys past Sk (only in a
    // partial last tile) are masked out
    const int kv0 = it * BK;
    if (kv0 + BK > Sk) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + n * 8 + 2 * t + (e & 1) >= Sk) s[n][e] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = ex2(fmaf(s[n][0], scale_log2, -mn0));
      s[n][1] = ex2(fmaf(s[n][1], scale_log2, -mn0));
      s[n][2] = ex2(fmaf(s[n][2], scale_log2, -mn1));
      s[n][3] = ex2(fmaf(s[n][3], scale_log2, -mn1));
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P V: the score accumulators of n-tiles 2j, 2j+1 are PV's A
    // operand for keys 16j..16j+15, rounded to bf16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                        pack_bf16(s[2 * j][2], s[2 * j][3]),
                        pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                        pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        unsigned vf[4];
        const int mi = lane >> 3;
        ldmatrix_x4_trans(vf, cV + (j * 16 + (mi & 1) * 8 + (lane & 7)) * LD + p * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * p], pa, vf[0], vf[1]);
        mma_bf16(o[2 * p + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
  const float i0 = 1.f / ls0, i1 = 1.f / ls1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  bf16* ob = out + (long long)b * o_bs + (long long)h * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= D) continue;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * o_rs + c) =
          __floats2bfloat162_rn(o[n][0] * i0, o[n][1] * i0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * o_rs + c) =
          __floats2bfloat162_rn(o[n][2] * i1, o[n][3] * i1);
  }
  if (t == 0) {
    float* lb = lse + ((long long)b * H + h) * Sq;
    if (r0 < Sq) lb[r0] = (m0 + log2f(ls0)) * LN2;
    if (r1 < Sq) lb[r1] = (m1 + log2f(ls1)) * LN2;
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int Sq, int Sk, int D, long long q_bs, long long q_rs,
           long long k_bs, long long k_rs, long long v_bs, long long v_rs,
           long long o_bs, long long o_rs, int kv_group, float scale,
           cudaStream_t stream) {
  const size_t smem = Cfg<DP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, Sq, Sk, D, q_bs, q_rs, k_bs, k_rs, v_bs,
      v_rs, o_bs, o_rs, kv_group, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H*D), k/v (B / kv_group, Sk, H*D), out (B, Sq, H*D) bf16 with the
// given batch / row strides (elements, unit channel stride); lse (B, H, Sq)
// f32. D a multiple of 8, at most 128.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out,
                         void* lse, int B, int H, int Sq, int Sk, int D,
                         long long q_bs, long long q_rs, long long k_bs,
                         long long k_rs, long long v_bs, long long v_rs,
                         long long o_bs, long long o_rs, int kv_group,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define A3D_CASE(DP)                                                          \
  case DP:                                                                    \
    return launch<DP>(q, k, v, out, lse, B, H, Sq, Sk, D, q_bs, q_rs, k_bs,   \
                      k_rs, v_bs, v_rs, o_bs, o_rs, kv_group, scale, s);
  switch ((D + 15) / 16 * 16) {
    A3D_CASE(16)
    A3D_CASE(32)
    A3D_CASE(48)
    A3D_CASE(64)
    A3D_CASE(80)
    A3D_CASE(96)
    A3D_CASE(112)
    A3D_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef A3D_CASE
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
