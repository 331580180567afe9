// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces: animate3d_tpu/ops/attention.py::_flash_kernel_wholek and
// _flash_kernel, reached through _flash_fwd_impl_merged /
// flash_attention_padded (the TPU's lane-padded merged-head route, heads 40
// and 80 wide) and _flash_attention_fwd_impl (its unpadded route, which
// multi_head_attention takes at the 160-wide heads).
//
// Computes, per (batch, head), the non-causal unmasked attention
//   out = softmax(q k^T * scale) v,   lse = log(sum(exp(q k^T * scale)))
// reading q/k/v straight from the merged (B, S, H*D) layout through TMA
// tensor maps (no 128-lane head padding: D = 40 reads as 48 with zero
// columns, 80 and 160 as they are). K/V may be shared by `kv_group`
// consecutive query batches (the I2V branches' frame-0 K/V) through their
// batch coordinate b / kv_group, so the broadcast is never materialised.
//
// Numerics: f32 scores, the scale applied to them after the dot, exact
// online softmax in exp2 form (the SFU's ex2.approx), bf16 P in the PV
// product with f32 accumulation, division by the f32 row sum after PV with
// a 1e-30 floor, lse in natural log. The TPU's skip-max clamp for Sk >= 2048
// is not reproduced (it only differs once a base-2 logit passes 110).
//
// Bound on the H100: per score the tensor cores do 4 * DP flops (QK^T and
// PV) and the SFU one ex2, at 989e12 flop/s against 3.9e12 ex2/s. At D 40
// (DP 48) that is 0.19 against 0.26 ns a score, so the SFU binds; at D 80
// and 160 the tensor cores do. Either way the softmax of one 64-row block
// has to run while the tensor cores work on another. Design (FlashAttention
// 3's shape): a CTA of three warpgroups owns 128 query rows of one (batch,
// head). One producer warp issues TMA loads of 128-key K and V tiles into
// two 2-stage shared-memory rings gated by full / empty mbarriers (Q is
// loaded once); the producer warpgroup gives up its registers (setmaxnreg)
// to the two consumer warpgroups, each of which owns 64 query rows. In its
// turn a consumer issues S(j) = Q K(j)^T (wgmma, both operands in shared
// memory) and O += P(j-1) V(j-1) (wgmma with P from registers: the score
// accumulators, rounded to bf16, are the A fragments in place), then
// computes the softmax of S(j) while those run. The turns alternate through
// a pair of named barriers (ping-pong), so one consumer's softmax on the SFU
// and FMA pipes overlaps the other's products on the tensor cores.

#include <math.h>

#include "hopper_common.cuh"
#include "wgmma_ops.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;  // query rows per CTA: 64 per consumer warpgroup
constexpr int BK = 128;  // keys per K/V tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float LN2 = 0.6931471805599453f;

template <int DP>
struct Cfg {
  static constexpr int KD = DP / 16;              // 16-column chunks, k-steps of QK^T
  static constexpr int Q_BYTES = KD * BQ * 32;    // the Q tile
  static constexpr int KV_BYTES = KD * BK * 32;   // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int USED = BAR_OFF + 128 + 1024;  // barriers, alignment slack
  // at least 116 KB, so that one CTA holds an SM: the register split of
  // setmaxnreg assumes that no second CTA shares it
  static constexpr int SMEM = USED > 118784 ? USED : 118784;
};

// online softmax of one 64 x 128 score tile, base 2, on the raw scores
// (scale > 0 keeps the max): p = 2^(s * scale_log2 - m) as one FMA + ex2,
// in place; keys past Sk (only in a partial last tile, read as TMA's zero
// fill) are masked out. Updates the running max m and this thread's share
// of the row sums l of rows g and g + 8; returns the rescale factors of
// the output rows in a0, a1.
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], int kv0, int Sk, int t,
                                               float scale_log2, float& m0, float& m1,
                                               float& l0, float& l1, float& a0, float& a1) {
  if (kv0 + BK > Sk) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kv0 + n * 8 + 2 * t + (e & 1) >= Sk) sc[4 * n + e] = -INFINITY;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
  a0 = hop::ex2(m0 - mn0);
  a1 = hop::ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    sc[4 * n] = hop::ex2(fmaf(sc[4 * n], scale_log2, -mn0));
    sc[4 * n + 1] = hop::ex2(fmaf(sc[4 * n + 1], scale_log2, -mn0));
    sc[4 * n + 2] = hop::ex2(fmaf(sc[4 * n + 2], scale_log2, -mn1));
    sc[4 * n + 3] = hop::ex2(fmaf(sc[4 * n + 3], scale_log2, -mn1));
    ps0 += sc[4 * n] + sc[4 * n + 1];
    ps1 += sc[4 * n + 2] + sc[4 * n + 3];
  }
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
}

// P in bf16 as PV's A fragments: n-tiles 2j, 2j + 1 are keys 16j .. 16j + 15
__device__ __forceinline__ void pack_p(unsigned (&pa)[BK / 16][4], const float (&sc)[BK / 2]) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    pa[j][0] = hop::pack_bf16(sc[8 * j], sc[8 * j + 1]);
    pa[j][1] = hop::pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
    pa[j][2] = hop::pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
    pa[j][3] = hop::pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Sk, int D, long long o_bs,
                 long long o_rs, int kv_group, float scale_log2) {
  using C = Cfg<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::smem_base(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sK = smem + C::Q_BYTES;              // [STAGES] K tiles
  unsigned char* sV = sK + STAGES * C::KV_BYTES;      // [STAGES] V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (Sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full_k[s], 1);
      hop::mbar_init(&full_v[s], 1);
      hop::mbar_init(&empty_k[s], 256);
      hop::mbar_init(&empty_v[s], 256);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the TMA loads in flight, K and V on rings
    // of their own (K(j) is free once S(j) is computed, V(j) only after
    // P(j) V(j), which a consumer issues one tile later)
    hop::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int bkv = b / kv_group;
      hop::mbar_arrive_tx(full_q, C::Q_BYTES);
      for (int kk = 0; kk < C::KD; ++kk)
        hop::tma_load_4d(sQ + kk * BQ * 32, &tq, full_q, kk * 16, h, qt * BQ, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        const unsigned free_parity = ((it / STAGES) & 1) ^ 1;
        hop::mbar_wait(&empty_k[s], free_parity);
        hop::mbar_arrive_tx(&full_k[s], C::KV_BYTES);
        for (int kk = 0; kk < C::KD; ++kk)
          hop::tma_load_4d(sK + s * C::KV_BYTES + kk * BK * 32, &tk, &full_k[s], kk * 16, h,
                           it * BK, bkv);
        hop::mbar_wait(&empty_v[s], free_parity);
        hop::mbar_arrive_tx(&full_v[s], C::KV_BYTES);
        for (int kk = 0; kk < C::KD; ++kk)
          hop::tma_load_4d(sV + s * C::KV_BYTES + kk * BK * 32, &tv, &full_v[s], kk * 16, h,
                           it * BK, bkv);
      }
    }
    return;
  }

  hop::reg_alloc<CONSUMER_REGS>();
  const int c = wg - 1;  // consumer index: query rows [64c, 64c + 64) of the tile
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (base 2) of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their row sums
  float sc[BK / 2];                      // S(j), then P(j) in f32
  unsigned pa[BK / 16][4];               // P(j - 1) in bf16: PV's A fragments

  // ping-pong: consumer c issues its products after barrier 1 + c completes
  // and then arrives at the other's, so one consumer's products run on the
  // tensor cores while the other computes its softmax; consumer 0 goes first
  if (c == 1) hop::bar_arrive(1, 256);
  hop::mbar_wait(full_q, 0);
  float a0, a1;

  // tile 0: S(0) = Q K(0)^T alone (K-major operands in shared memory)
  hop::mbar_wait(&full_k[0], 0);
  hop::bar_sync(1 + c, 256);
  hop::wg_fence();
#pragma unroll
  for (int kk = 0; kk < C::KD; ++kk)
    Wgmma<BK>::template ss<0, 0>(sc, hop::sw32_desc(sQ + kk * BQ * 32 + c * 64 * 32, 16, 256),
                                 hop::sw32_desc(sK + kk * BK * 32, 16, 256), kk > 0);
  hop::wg_commit();
  if (c == 0 || ntiles > 1) hop::bar_arrive(2 - c, 256);
  hop::wg_wait<0>();
  hop::fence_regs(sc);
  hop::mbar_arrive(&empty_k[0]);
  online_softmax(sc, 0, Sk, t, scale_log2, m0, m1, l0, l1, a0, a1);
  pack_p(pa, sc);

  for (int it = 1; it < ntiles; ++it) {
    const int s = it % STAGES, sp = (it - 1) % STAGES;
    hop::mbar_wait(&full_k[s], (it / STAGES) & 1);
    hop::mbar_wait(&full_v[sp], ((it - 1) / STAGES) & 1);

    // in this consumer's turn: S(j) = Q K(j)^T and O += P(j-1) V(j-1)
    // (P from registers, V the MN-major B operand: keys as the depth, head
    // columns on N); the softmax of S(j) then runs while P V does
    hop::bar_sync(1 + c, 256);
    hop::fence_regs(o);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk)
      Wgmma<BK>::template ss<0, 0>(
          sc, hop::sw32_desc(sQ + kk * BQ * 32 + c * 64 * 32, 16, 256),
          hop::sw32_desc(sK + s * C::KV_BYTES + kk * BK * 32, 16, 256), kk > 0);
    hop::wg_commit();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      Wgmma<DP>::template rs<1>(
          o, pa[j], hop::sw32_desc(sV + sp * C::KV_BYTES + j * 16 * 32, BK * 32, 256), 1);
    hop::wg_commit();
    if (c == 0 || it + 1 < ntiles) hop::bar_arrive(2 - c, 256);
    hop::wg_wait<1>();
    hop::fence_regs(sc);
    hop::mbar_arrive(&empty_k[s]);
    online_softmax(sc, it * BK, Sk, t, scale_log2, m0, m1, l0, l1, a0, a1);

    // O = O(j-1) once P(j-1) V(j-1) is in: rescale it for the new max
    hop::wg_wait<0>();
    hop::fence_regs(o);
    hop::mbar_arrive(&empty_v[sp]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }
    pack_p(pa, sc);
  }

  // the last tile's P V
  const int sl = (ntiles - 1) % STAGES;
  hop::mbar_wait(&full_v[sl], ((ntiles - 1) / STAGES) & 1);
  hop::fence_regs(o);
  hop::wg_fence();
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    Wgmma<DP>::template rs<1>(
        o, pa[j], hop::sw32_desc(sV + sl * C::KV_BYTES + j * 16 * 32, BK * 32, 256), 1);
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::fence_regs(o);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
  const float i0 = 1.f / ls0, i1 = 1.f / ls1;
  const int r0 = qt * BQ + c * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  bf16* ob = out + (long long)b * o_bs + (long long)h * D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= D) continue;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * o_rs + col) =
          __floats2bfloat162_rn(o[4 * n] * i0, o[4 * n + 1] * i0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * o_rs + col) =
          __floats2bfloat162_rn(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
  }
  if (t == 0) {
    float* lb = lse + ((long long)b * H + h) * Sq;
    if (r0 < Sq) lb[r0] = (m0 + log2f(ls0)) * LN2;
    if (r1 < Sq) lb[r1] = (m1 + log2f(ls1)) * LN2;
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
           int Sq, int Sk, int D, long long q_bs, long long q_rs, long long k_bs,
           long long k_rs, long long v_bs, long long v_rs, long long o_bs, long long o_rs,
           int kv_group, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!hop::head_map(&tq, q, B, Sq, H, D, q_bs, q_rs, BQ) ||
      !hop::head_map(&tk, k, B / kv_group, Sk, H, D, k_bs, k_rs, BK) ||
      !hop::head_map(&tv, v, B / kv_group, Sk, H, D, v_bs, v_rs, BK))
    return (int)cudaErrorInvalidValue;
  const int smem = Cfg<DP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), H, Sq, Sk, D, o_bs, o_rs,
      kv_group, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H*D), k/v (B / kv_group, Sk, H*D), out (B, Sq, H*D) bf16 with the
// given batch / row strides (elements, unit channel stride; strides and
// bases 16-byte aligned); lse (B, H, Sq) f32. D is 40, 80 or 160.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         int B, int H, int Sq, int Sk, int D, long long q_bs, long long q_rs,
                         long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                         long long o_bs, long long o_rs, int kv_group, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define A3D_CASE(DW, DP)                                                                    \
  case DW:                                                                                  \
    return launch<DP>(q, k, v, out, lse, B, H, Sq, Sk, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, \
                      o_bs, o_rs, kv_group, scale, s);
  switch (D) {
    A3D_CASE(40, 48)
    A3D_CASE(80, 80)
    A3D_CASE(160, 160)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef A3D_CASE
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
