// Flash-attention backward for Hopper (sm_90a), bf16 in/out, f32 sums.
//
// Replaces: animate3d_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel, reached through _flash_bwd_impl_merged /
// flash_attention_padded's VJP (the TPU's FlashAttention-2 backward).
//
// With S = q k^T * scale, P = exp(S - lse) rebuilt from the forward's
// natural-log row lse (flash_fwd.cu), dP = dO v^T and Delta = rowsum(dO o)
// (f32, computed by the caller), dS = P (dP - Delta) and
//   dq = scale * dS k,   dk = scale * dS^T q,   dv = P^T dO.
// P and dS are rounded to bf16 where they enter a product, as the TPU
// kernels round them. The scale multiplies the f32 scores after the dot and
// no 110 clamp is applied, exactly as flash_fwd.cu built the lse. q/k/v/dO
// are read from the merged (B, S, H*D) layout by stride; D is padded to a
// multiple of 16 in shared memory only. K/V (and dK/dV) may belong to
// `kv_group` consecutive query batches (the I2V branches' frame-0 K/V).
//
// Bound on the H100: the five S x S x D products (10*B*H*Sq*Sk*D flops)
// dwarf the bytes at the trainer's shapes (S = 4096, D = 40), so the tensor
// cores bind. Design (FlashAttention-2 on mma.sync, as flash_fwd.cu): two
// kernels, so that neither needs atomics. flash_bwd_dq_kernel: one CTA of 4
// warps owns a 64-row q tile of one (batch, head) with its Q and dO
// fragments in registers, streams 64-key K/V tiles through a 2-stage
// cp.async ring, and keeps S, P, dP and dS in registers; dS's accumulators
// become the dS K product's A operand in place. flash_bwd_dkv_kernel: one
// CTA owns a 64-key K/V tile of one (kv batch, head), keeps its K fragments
// in registers and streams the q / dO tiles (with their lse and Delta) of
// ALL the kv_group query batches that read it, so the group's dK/dV sum
// stays in f32 registers: no broadcast copy and no cross-CTA reduction.
// Rows are keys there, so S^T and dP^T are the tiles in registers and P^T,
// dS^T are the A operands of dV += P^T dO and dK += dS^T q.
// Not yet: wgmma, TMA, warp specialisation.

#include <math.h>

#include "mma_common.cuh"

namespace {

constexpr int WARPS = 4;  // 16 rows per warp, 64 rows per CTA
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Cfg {
  static constexpr int LD = DP + 8;     // padded smem row: conflict-free ldmatrix
  static constexpr int TILE = 64 * LD;  // elements of one 64-row tile
  // six bf16 tiles, plus two stages of 64 lse and 64 Delta values (dkv)
  static constexpr size_t SMEM = (size_t)6 * TILE * sizeof(bf16) + 4 * 64 * sizeof(float);
};

// B-operand fragments of rows [n0, n0 + 16) of a (rows, LD) tile whose rows
// are the product's n index (x @ tile^T): b[0], b[1] for n-tile n0 / 8 and
// b[2], b[3] for the next, over head-dim columns [k0, k0 + 16)
__device__ __forceinline__ void frag_nt(unsigned (&b)[4], const bf16* tile, int LD, int n0,
                                        int k0, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4(b, tile + (n0 + (mi >> 1) * 8 + (lane & 7)) * LD + k0 + (mi & 1) * 8);
}

// B-operand fragments of rows [k0, k0 + 16) of a tile whose rows are the
// product's k index (x @ tile), for head-dim columns [n0, n0 + 16)
__device__ __forceinline__ void frag_nn(unsigned (&b)[4], const bf16* tile, int LD, int k0,
                                        int n0, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4_trans(b, tile + (k0 + (mi & 1) * 8 + (lane & 7)) * LD + n0 + (mi >> 1) * 8);
}

// A-operand fragments of this warp's 16 rows of a tile, head-dim columns [k0, k0 + 16)
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const bf16* tile, int LD, int warp,
                                       int k0, int lane) {
  ldmatrix_x4(a, tile + (warp * 16 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// the 16 x 16 A operand of keys / queries [16j, 16j + 16) from the f32
// accumulators of n-tiles 2j, 2j + 1 (rounded to bf16)
__device__ __forceinline__ void pack_a(unsigned (&a)[4], const float (&x)[8][4], int j) {
  a[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
  a[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
  a[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
  a[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
}

template <int ND>
__device__ __forceinline__ void store_rows(bf16* base, long long rs, const float (&acc)[ND][4],
                                           float mul, int r0, int limit, int D, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= D) continue;
    if (r0 < limit)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r0 * rs + c) =
          __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    if (r1 < limit)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r1 * rs + c) =
          __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Sq, int Sk, int D, long long q_bs,
                    long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                    long long v_rs, long long do_bs, long long do_rs, long long dq_bs,
                    long long dq_rs, int kv_group, float scale, float scale_log2) {
  constexpr int LD = Cfg<DP>::LD;
  constexpr int TILE = Cfg<DP>::TILE;
  constexpr int KD = DP / 16;  // k-steps over the head dim
  constexpr int ND = DP / 8;   // 8-wide output column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + TILE;
  bf16* sK[2] = {sQ + 2 * TILE, sQ + 4 * TILE};
  bf16* sV[2] = {sQ + 3 * TILE, sQ + 5 * TILE};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const bf16* kb = k + (long long)(b / kv_group) * k_bs + (long long)h * D;
  const bf16* vb = v + (long long)(b / kv_group) * v_bs + (long long)h * D;
  const int ntiles = (Sk + 63) / 64;

  load_tile<DP, LD>(sQ, q + (long long)b * q_bs + (long long)h * D, q_rs, q0, Sq, D);
  load_tile<DP, LD>(sdO, dout + (long long)b * do_bs + (long long)h * D, do_rs, q0, Sq, D);
  load_tile<DP, LD>(sK[0], kb, k_rs, 0, Sk, D);
  load_tile<DP, LD>(sV[0], vb, v_rs, 0, Sk, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q and dO A-fragments, kept in registers for every K/V tile
  unsigned qf[KD][4], df[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    frag_a(qf[kk], sQ, LD, warp, kk * 16, lane);
    frag_a(df[kk], sdO, LD, warp, kk * 16, lane);
  }
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long long row = ((long long)b * H + h) * Sq;
  const float l0 = r0 < Sq ? lse[row + r0] * LOG2E : 0.f;
  const float l1 = r1 < Sq ? lse[row + r1] * LOG2E : 0.f;
  const float d0 = r0 < Sq ? delta[row + r0] : 0.f;
  const float d1 = r1 < Sq ? delta[row + r1] : 0.f;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      load_tile<DP, LD>(sK[st ^ 1], kb, k_rs, (it + 1) * 64, Sk, D);
      load_tile<DP, LD>(sV[st ^ 1], vb, v_rs, (it + 1) * 64, Sk, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK[st];
    const bf16* cV = sV[st];

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned f[4];
        frag_nt(f, cK, LD, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qf[kk], f[0], f[1]);
        mma_bf16(s[2 * np + 1], qf[kk], f[2], f[3]);
        frag_nt(f, cV, LD, np * 16, kk * 16, lane);
        mma_bf16(dp[2 * np], df[kk], f[0], f[1]);
        mma_bf16(dp[2 * np + 1], df[kk], f[2], f[3]);
      }
    }

    // dS = P (dP - Delta), P = 2^(s * scale_log2 - lse_2); keys past Sk
    // (only in a partial last tile) get P = 0
    const int kv0 = it * 64;
    const bool ragged = kv0 + 64 > Sk;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[n][e], scale_log2, -(e < 2 ? l0 : l1)));
        if (ragged && kv0 + n * 8 + 2 * t + (e & 1) >= Sk) p = 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? d0 : d1));
      }

    // dQ += dS K: the dS accumulators of n-tiles 2j, 2j+1 are the A operand
    // for keys 16j..16j+15, rounded to bf16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned a[4];
      pack_a(a, s, j);
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        unsigned f[4];
        frag_nn(f, cK, LD, j * 16, p * 16, lane);
        mma_bf16(acc[2 * p], a, f[0], f[1]);
        mma_bf16(acc[2 * p + 1], a, f[2], f[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
  }
  store_rows<ND>(dq + (long long)b * dq_bs + (long long)h * D, dq_rs, acc, scale, r0, Sq, D, t);
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk,
                     int D, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                     long long v_bs, long long v_rs, long long do_bs, long long do_rs,
                     long long dkv_bs, long long dkv_rs, int kv_group, float scale,
                     float scale_log2) {
  constexpr int LD = Cfg<DP>::LD;
  constexpr int TILE = Cfg<DP>::TILE;
  constexpr int KD = DP / 16;
  constexpr int ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE;
  bf16* sQ[2] = {sK + 2 * TILE, sK + 4 * TILE};
  bf16* sdO[2] = {sK + 3 * TILE, sK + 5 * TILE};
  float* sL = reinterpret_cast<float*>(sK + 6 * TILE);  // [2][64] lse * log2(e)
  float* sD = sL + 2 * 64;                             // [2][64] Delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * 64, h = blockIdx.y, bk = blockIdx.z;
  const int nqt = (Sq + 63) / 64;
  const int total = kv_group * nqt;  // q tiles of every query batch reading this K/V

  // q / dO tiles and their lse / Delta rows for step `it` into stage `st`;
  // rows past Sq get lse = +inf (P = 0) and Delta = 0
  auto issue = [&](int it, int st) {
    const int b = bk * kv_group + it / nqt, q0 = (it % nqt) * 64;
    load_tile<DP, LD>(sQ[st], q + (long long)b * q_bs + (long long)h * D, q_rs, q0, Sq, D);
    load_tile<DP, LD>(sdO[st], dout + (long long)b * do_bs + (long long)h * D, do_rs, q0,
                      Sq, D);
    const int i = threadIdx.x & 63, r = q0 + i;
    const long long row = ((long long)b * H + h) * Sq;
    if (threadIdx.x < 64)
      sL[st * 64 + i] = r < Sq ? lse[row + r] * LOG2E : INFINITY;
    else
      sD[st * 64 + i] = r < Sq ? delta[row + r] : 0.f;
  };

  load_tile<DP, LD>(sK, k + (long long)bk * k_bs + (long long)h * D, k_rs, k0, Sk, D);
  load_tile<DP, LD>(sV, v + (long long)bk * v_bs + (long long)h * D, v_rs, k0, Sk, D);
  issue(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  unsigned kf[KD][4];  // this warp's 16 keys, kept in registers
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) frag_a(kf[kk], sK, LD, warp, kk * 16, lane);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    if (it + 1 < total) issue(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cQ = sQ[st];
    const bf16* cdO = sdO[st];
    const float* cL = sL + st * 64;
    const float* cD = sD + st * 64;

    // S^T = K Q^T for this warp's 16 keys x 64 queries, then P^T in place
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned f[4];
        frag_nt(f, cQ, LD, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], kf[kk], f[0], f[1]);
        mma_bf16(s[2 * np + 1], kf[kk], f[2], f[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float la = cL[n * 8 + 2 * t], lb = cL[n * 8 + 2 * t + 1];
      s[n][0] = ex2(fmaf(s[n][0], scale_log2, -la));
      s[n][1] = ex2(fmaf(s[n][1], scale_log2, -lb));
      s[n][2] = ex2(fmaf(s[n][2], scale_log2, -la));
      s[n][3] = ex2(fmaf(s[n][3], scale_log2, -lb));
    }

    // dV += P^T dO (P^T rounded to bf16 as the A operand)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned a[4];
      pack_a(a, s, j);
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        unsigned f[4];
        frag_nn(f, cdO, LD, j * 16, p * 16, lane);
        mma_bf16(dva[2 * p], a, f[0], f[1]);
        mma_bf16(dva[2 * p + 1], a, f[2], f[3]);
      }
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - Delta) in place
    float dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned vf[4];
      frag_a(vf, sV, LD, warp, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned f[4];
        frag_nt(f, cdO, LD, np * 16, kk * 16, lane);
        mma_bf16(dp[2 * np], vf, f[0], f[1]);
        mma_bf16(dp[2 * np + 1], vf, f[2], f[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float da = cD[n * 8 + 2 * t], db = cD[n * 8 + 2 * t + 1];
      dp[n][0] = s[n][0] * (dp[n][0] - da);
      dp[n][1] = s[n][1] * (dp[n][1] - db);
      dp[n][2] = s[n][2] * (dp[n][2] - da);
      dp[n][3] = s[n][3] * (dp[n][3] - db);
    }

    // dK += dS^T Q (dS^T rounded to bf16 as the A operand)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned a[4];
      pack_a(a, dp, j);
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        unsigned f[4];
        frag_nn(f, cQ, LD, j * 16, p * 16, lane);
        mma_bf16(dka[2 * p], a, f[0], f[1]);
        mma_bf16(dka[2 * p + 1], a, f[2], f[3]);
      }
    }
    __syncthreads();  // this stage is refilled two steps from now
  }
  const int r0 = k0 + warp * 16 + g;
  const long long off = (long long)bk * dkv_bs + (long long)h * D;
  store_rows<ND>(dk + off, dkv_rs, dka, scale, r0, Sk, D, t);
  store_rows<ND>(dv + off, dkv_rs, dva, 1.f, r0, Sk, D, t);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int H, int Sq, int Sk, int D,
              long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs,
              long long v_rs, long long do_bs, long long do_rs, long long dq_bs,
              long long dq_rs, int kv_group, float scale, cudaStream_t stream) {
  const size_t smem = Cfg<DP>::SMEM;
  const int err = prepare(flash_bwd_dq_kernel<DP>, smem);
  if (err) return err;
  dim3 grid((Sq + 63) / 64, H, B);
  flash_bwd_dq_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Sq, Sk, D, q_bs, q_rs,
      k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, dq_bs, dq_rs, kv_group, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
               long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs,
               long long v_rs, long long do_bs, long long do_rs, long long dkv_bs,
               long long dkv_rs, int kv_group, float scale, cudaStream_t stream) {
  const size_t smem = Cfg<DP>::SMEM;
  const int err = prepare(flash_bwd_dkv_kernel<DP>, smem);
  if (err) return err;
  dim3 grid((Sk + 63) / 64, H, B / kv_group);
  flash_bwd_dkv_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
      Sq, Sk, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, dkv_bs, dkv_rs, kv_group,
      scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout (B, Sq, H*D), k/v (B / kv_group, Sk, H*D) bf16 with the given
// batch / row strides (elements, unit channel stride); lse, delta (B, H, Sq)
// f32 contiguous; dq (B, Sq, H*D) bf16. D a multiple of 8, at most 128.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int H,
                            int Sq, int Sk, int D, long long q_bs, long long q_rs,
                            long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                            long long do_bs, long long do_rs, long long dq_bs,
                            long long dq_rs, int kv_group, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define A3D_CASE(DP)                                                                      \
  case DP:                                                                                \
    return launch_dq<DP>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D, q_bs, q_rs, k_bs, \
                         k_rs, v_bs, v_rs, do_bs, do_rs, dq_bs, dq_rs, kv_group, scale, s);
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

// as flash_bwd_dq; dk/dv (B / kv_group, Sk, H*D) bf16 with strides dkv_*,
// each the f32 sum over the kv_group query batches that read that K/V batch
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B,
                             int H, int Sq, int Sk, int D, long long q_bs, long long q_rs,
                             long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                             long long do_bs, long long do_rs, long long dkv_bs,
                             long long dkv_rs, int kv_group, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define A3D_CASE(DP)                                                                       \
  case DP:                                                                                 \
    return launch_dkv<DP>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D, q_bs, q_rs,  \
                          k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, dkv_bs, dkv_rs, kv_group, \
                          scale, s);
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

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
