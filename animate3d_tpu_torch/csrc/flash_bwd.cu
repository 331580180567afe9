// Flash-attention backward for Hopper (sm_90a), bf16 in/out, f32 sums.
//
// Replaces: animate3d_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel, reached through _flash_bwd_impl_merged /
// flash_attention_padded's VJP (heads 40 and 80 wide) and
// _flash_attention_bwd_impl (the unpadded route of the 160-wide heads).
//
// With S = q k^T * scale, P = exp(S - lse) rebuilt from the forward's
// natural-log row lse (flash_fwd.cu), dP = dO v^T, Delta = rowsum(dO o) in
// f32, dS = P (dP - Delta) and
//   dq = scale * dS k,   dk = scale * dS^T q,   dv = P^T dO.
// P and dS are rounded to bf16 where they enter a product, as the TPU
// kernels round them. The scale multiplies the f32 scores after the dot and
// no 110 clamp is applied, exactly as flash_fwd.cu built the lse. q/k/v/dO
// are read from the merged (B, S, H*D) layout through TMA tensor maps (D 40
// reads as 48 with zero columns). K/V (and dK/dV) may belong to `kv_group`
// consecutive query batches (the I2V branches' frame-0 K/V).
//
// Three launches: flash_bwd_delta_kernel computes Delta (B, H, Sq) from o
// and dO; flash_bwd_kernel makes one pass per 128-key tile; cast kernels
// scale the f32 dQ sums into bf16 dq (and, when a K/V batch's query
// batches were split over CTAs, the f32 dK / dV sums into dk / dv).
//
// Bound on the H100: five S x S x D products (10 * DP flops a score on the
// tensor cores) and one ex2 a score on the SFU; at DP 48 that is 0.49
// against 0.26 ns a score, so the tensor cores bind at every head width.
// Design (FlashAttention-3's backward): a CTA of three warpgroups owns one
// 128-key K/V tile of one (kv batch, head), loaded once by TMA. A producer
// warp streams 64-query Q / dO tiles (with their lse and Delta rows) of
// the CTA's query batches through a 2-stage ring gated by mbarriers; two
// consumer warpgroups each own 64 keys and keep their dK and dV in
// registers. Per query tile a consumer computes S^T = K Q^T and
// dP^T = V dO^T (wgmma, both operands in shared memory), P^T with one ex2 a
// score and dS^T in registers, dV += P^T dO and dK += dS^T Q (wgmma with
// P^T / dS^T as register A fragments), and writes dS^T to shared memory;
// then the two split the columns of dQ = dS K over all 128 keys (wgmma,
// both operands MN-major) and add the tile to an f32 dQ scratch (B, H, Sq,
// D) with vector atomics (red.global.add.v2.f32). That makes 5 products
// and one ex2 a score, where the earlier two-kernel design made 7 and two.
// The atomics change the f32 summation order of dQ from run to run. The
// key tiles of one (batch, head) start at different query tiles, so their
// atomics meet different rows. kv_group query batches are split over
// `nsplit` CTAs so that the I2V shape fills the card; their dK / dV meet in
// f32 scratch by the same atomics and are rounded to bf16 once, in a cast
// kernel.

#include <math.h>

#include "hopper_common.cuh"
#include "wgmma_ops.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BK = 128;  // keys per CTA: 64 per consumer warpgroup
constexpr int BQ = 64;   // queries per streamed tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Cfg {
  static constexpr int KD = DP / 16;
  static constexpr int KV_BYTES = KD * BK * 32;  // the K or V tile
  static constexpr int QT_BYTES = KD * BQ * 32;  // one Q or dO tile
  static constexpr int DS_BYTES = BQ * BK * 2;   // one dS^T buffer (128 keys x 64 queries)
  static constexpr int STAGE_OFF = 2 * KV_BYTES;
  static constexpr int DS_OFF = STAGE_OFF + STAGES * 2 * QT_BYTES;
  static constexpr int LD_OFF = DS_OFF + 2 * DS_BYTES;  // lse * log2(e), then Delta
  static constexpr int BAR_OFF = LD_OFF + STAGES * 2 * BQ * 4;
  static constexpr int USED = BAR_OFF + 64 + 1024;
  static constexpr int SMEM = USED > 118784 ? USED : 118784;  // one CTA an SM
  // dQ columns of consumer 0 and 1 (each a multiple of 16)
  static constexpr int NQ0 = (KD + 1) / 2 * 16;
  static constexpr int NQ1 = DP - NQ0;
};

// The end of one query tile for a consumer: dV += P^T dO and dK += dS^T Q
// (A fragments from registers, B MN-major: queries as the depth, head
// columns on N); then, once both consumers' dS^T are in shared memory, its
// columns [n0, n0 + NQ) of dQ = dS K over the CTA's 128 keys (both operands
// MN-major), added to the f32 scratch (B, H, Sq, D) with vector atomics
// (red.global.add.v2.f32). The stage is released once the products that
// read it are done.
template <int DP, int NQ>
__device__ __forceinline__ void tile_tail(float (&dka)[DP / 2], float (&dva)[DP / 2],
                                          const unsigned (&pa)[BQ / 16][4],
                                          const unsigned (&da)[BQ / 16][4],
                                          const unsigned char* sQ, const unsigned char* sdO,
                                          const unsigned char* dsb, const unsigned char* sK,
                                          int n0, uint64_t* empty, bool need_dq, bool need_dkv,
                                          float* __restrict__ dq_tile, int rows_left, int D,
                                          int warp, int lane) {
  if (need_dkv) {
    hop::fence_regs(dva);
    hop::fence_regs(dka);
    hop::wg_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j)
      Wgmma<DP>::template rs<1>(dva, pa[j], hop::sw32_desc(sdO + j * 512, BQ * 32, 256), 1);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j)
      Wgmma<DP>::template rs<1>(dka, da[j], hop::sw32_desc(sQ + j * 512, BQ * 32, 256), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(dva);
    hop::fence_regs(dka);
  }
  if (!need_dq) {
    hop::mbar_arrive(empty);
    return;
  }
  // both consumers' dS^T are in shared memory (the other buffer is the one
  // the previous query tile's dQ read: a consumer reaches this barrier only
  // after its own dQ of that tile finished)
  hop::bar_sync(1, 256);
  float acc[NQ / 2];
  hop::wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<NQ>::template ss<1, 1>(
        acc, hop::sw32_desc(dsb + kk * 512, BK * 32, 256),
        hop::sw32_desc(sK + (n0 / 16) * BK * 32 + kk * 512, BK * 32, 256), kk > 0);
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::fence_regs(acc);
  hop::mbar_arrive(empty);  // Q, dO, lse and Delta of this stage are read
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NQ / 8; ++n) {
    const int col = n0 + n * 8 + 2 * (lane & 3);
    if (col >= D) continue;
    if (r0 < rows_left)
      atomicAdd(reinterpret_cast<float2*>(dq_tile + r0 * D + col),
                make_float2(acc[4 * n], acc[4 * n + 1]));
    if (r1 < rows_left)
      atomicAdd(reinterpret_cast<float2*>(dq_tile + r1 * D + col),
                make_float2(acc[4 * n + 2], acc[4 * n + 3]));
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 float* __restrict__ dk_acc, float* __restrict__ dv_acc, int H, int Sq, int Sk,
                 int D, int kv_group, int nsplit, int need_dq, int need_dkv, float scale,
                 float scale_log2) {
  using C = Cfg<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::smem_base(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + C::KV_BYTES;
  float* sL = reinterpret_cast<float*>(smem + C::LD_OFF);  // [STAGES][BQ]
  float* sD = sL + STAGES * BQ;                             // [STAGES][BQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int kt = blockIdx.x, h = blockIdx.y;
  const int bkv = blockIdx.z / nsplit, per = kv_group / nsplit;
  const int b0 = bkv * kv_group + (blockIdx.z % nsplit) * per;  // this CTA's query batches
  const int nqt = (Sq + BQ - 1) / BQ, total = per * nqt;
  // the key tiles of one (batch, head) run at once and all add into its dQ:
  // each starts at another query tile, so their adds meet different rows
  const int rot = (int)(((long long)kt * nqt) / gridDim.x);
  const int k0 = kt * BK, Cw = H * D;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(full_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 32);
      hop::mbar_init(&empty[s], 256);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer warp: lane 0 issues the TMA loads; every lane stages two of
    // the tile's lse / Delta rows (rows past Sq: lse +inf, so P = 0)
    hop::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hop::mbar_arrive_tx(full_kv, 2 * C::KV_BYTES);
        for (int kk = 0; kk < C::KD; ++kk) {
          hop::tma_load_4d(sK + kk * BK * 32, &tk, full_kv, kk * 16, h, k0, bkv);
          hop::tma_load_4d(sV + kk * BK * 32, &tv, full_kv, kk * 16, h, k0, bkv);
        }
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % STAGES;
        const int b = b0 + it / nqt, q0 = (it + rot) % nqt * BQ;
        hop::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const long long row = ((long long)b * H + h) * Sq;
#pragma unroll
        for (int r = lane; r < BQ; r += 32) {
          const int qi = q0 + r;
          sL[s * BQ + r] = qi < Sq ? lse[row + qi] * LOG2E : INFINITY;
          sD[s * BQ + r] = qi < Sq ? delta[row + qi] : 0.f;
        }
        if (lane == 0) {
          unsigned char* sQ = smem + C::STAGE_OFF + s * 2 * C::QT_BYTES;
          hop::mbar_arrive_tx(&full[s], 2 * C::QT_BYTES);
          for (int kk = 0; kk < C::KD; ++kk) {
            hop::tma_load_4d(sQ + kk * BQ * 32, &tq, &full[s], kk * 16, h, q0, b);
            hop::tma_load_4d(sQ + C::QT_BYTES + kk * BQ * 32, &tdo, &full[s], kk * 16, h, q0,
                             b);
          }
        } else {
          hop::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  hop::reg_alloc<CONSUMER_REGS>();
  const int c = wg - 1;  // consumer index: keys [64c, 64c + 64) of the tile
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  hop::mbar_wait(full_kv, 0);

  // one query tile; the loop below takes two a trip, which makes the stage
  // and dS buffer of each a constant (it is even there)
  auto step = [&](int it) {
    const int s = it % STAGES;
    const int b = b0 + it / nqt, q0 = (it + rot) % nqt * BQ;
    hop::mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* sQ = smem + C::STAGE_OFF + s * 2 * C::QT_BYTES;
    const unsigned char* sdO = sQ + C::QT_BYTES;

    // S^T = K Q^T and dP^T = V dO^T: this consumer's 64 keys x 64 queries
    float st[BQ / 2], dpt[BQ / 2];
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk)
      Wgmma<BQ>::template ss<0, 0>(st, hop::sw32_desc(sK + kk * BK * 32 + c * 64 * 32, 16, 256),
                                   hop::sw32_desc(sQ + kk * BQ * 32, 16, 256), kk > 0);
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk)
      Wgmma<BQ>::template ss<0, 0>(dpt, hop::sw32_desc(sV + kk * BK * 32 + c * 64 * 32, 16, 256),
                                   hop::sw32_desc(sdO + kk * BQ * 32, 16, 256), kk > 0);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(st);
    hop::fence_regs(dpt);

    // P^T = 2^(s * scale_log2 - lse_2) and dS^T = P^T (dP^T - Delta) in
    // place; column 8n + 2t (+1) of the fragment is the query
    const float* L = sL + s * BQ;
    const float* Dl = sD + s * BQ;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t + (e & 1);
        const float p = hop::ex2(fmaf(st[4 * n + e], scale_log2, -L[j]));
        dpt[4 * n + e] = p * (dpt[4 * n + e] - Dl[j]);
        st[4 * n + e] = p;
      }
    unsigned pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[j][e] = hop::pack_bf16(st[8 * j + 2 * e], st[8 * j + 2 * e + 1]);
        da[j][e] = hop::pack_bf16(dpt[8 * j + 2 * e], dpt[8 * j + 2 * e + 1]);
      }
    unsigned char* dsb = smem + C::DS_OFF + (it & 1) * C::DS_BYTES;
    if (need_dq) {
      // dS^T (keys x queries) into shared memory, 32-byte swizzled with the
      // queries on the chunks: the MN-major A operand of dQ = dS K
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const int col = n * 8 + 2 * t, r = c * 64 + warp * 16 + g;
        *reinterpret_cast<unsigned*>(dsb + hop::sw32_offset(r, col, BK)) = da[n >> 1][2 * (n & 1)];
        *reinterpret_cast<unsigned*>(dsb + hop::sw32_offset(r + 8, col, BK)) =
            da[n >> 1][2 * (n & 1) + 1];
      }
      hop::fence_proxy_async();
    }
    float* dq_tile = dq_acc + (((long long)b * H + h) * Sq + q0) * D;
    if (c == 0)
      tile_tail<DP, C::NQ0>(dka, dva, pa, da, sQ, sdO, dsb, sK, 0, &empty[s], need_dq,
                            need_dkv, dq_tile, Sq - q0, D, warp, lane);
    else
      tile_tail<DP, C::NQ1>(dka, dva, pa, da, sQ, sdO, dsb, sK, C::NQ0, &empty[s], need_dq,
                            need_dkv, dq_tile, Sq - q0, D, warp, lane);
  };
  static_assert(STAGES == 2, "two query tiles a trip");
  for (int it = 0; it < total; it += 2) {
    step(it);
    if (it + 1 < total) step(it + 1);
  }

  if (!need_dkv) return;
  const int r0 = k0 + c * 64 + warp * 16 + g, r1 = r0 + 8;
  const long long base = (long long)bkv * Sk * Cw + (long long)h * D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= D) continue;
    if (nsplit == 1) {
      if (r0 < Sk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + (long long)r0 * Cw + col) =
            __floats2bfloat162_rn(dka[4 * n] * scale, dka[4 * n + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + (long long)r0 * Cw + col) =
            __floats2bfloat162_rn(dva[4 * n], dva[4 * n + 1]);
      }
      if (r1 < Sk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + (long long)r1 * Cw + col) =
            __floats2bfloat162_rn(dka[4 * n + 2] * scale, dka[4 * n + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + (long long)r1 * Cw + col) =
            __floats2bfloat162_rn(dva[4 * n + 2], dva[4 * n + 3]);
      }
    } else {
      if (r0 < Sk) {
        atomicAdd(reinterpret_cast<float2*>(dk_acc + base + (long long)r0 * Cw + col),
                  make_float2(dka[4 * n], dka[4 * n + 1]));
        atomicAdd(reinterpret_cast<float2*>(dv_acc + base + (long long)r0 * Cw + col),
                  make_float2(dva[4 * n], dva[4 * n + 1]));
      }
      if (r1 < Sk) {
        atomicAdd(reinterpret_cast<float2*>(dk_acc + base + (long long)r1 * Cw + col),
                  make_float2(dka[4 * n + 2], dka[4 * n + 3]));
        atomicAdd(reinterpret_cast<float2*>(dv_acc + base + (long long)r1 * Cw + col),
                  make_float2(dva[4 * n + 2], dva[4 * n + 3]));
      }
    }
  }
}

// Delta[b, h, q] = sum_d dO[b, q, h, d] o[b, q, h, d] in f32, one thread a
// (b, q, h) row of D (a multiple of 8) values
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ out,
                                       const bf16* __restrict__ dout, float* __restrict__ delta,
                                       int B, int H, int Sq, int D, long long o_bs, long long o_rs,
                                       long long do_bs, long long do_rs) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Sq * H) return;
  const int h = (int)(idx % H), q = (int)((idx / H) % Sq), b = (int)(idx / ((long long)H * Sq));
  const bf16* o = out + b * o_bs + q * o_rs + (long long)h * D;
  const bf16* g = dout + b * do_bs + q * do_rs + (long long)h * D;
  float acc = 0.f;
  for (int c = 0; c < D; c += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), d = __bfloat1622float2(g2[i]);
      acc = fmaf(a.x, d.x, acc);
      acc = fmaf(a.y, d.y, acc);
    }
  }
  delta[((long long)b * H + h) * Sq + q] = acc;
}

// out = bf16(in * mul) over n (a multiple of 4) contiguous values
__global__ void cast_scaled_kernel(const float* __restrict__ in, bf16* __restrict__ out,
                                   long long n, float mul) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n / 4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(in)[i];
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
    o[0] = __floats2bfloat162_rn(v.x * mul, v.y * mul);
    o[1] = __floats2bfloat162_rn(v.z * mul, v.w * mul);
  }
}

// dq (B, Sq, H*D) bf16 = scale * the f32 scratch (B, H, Sq, D), 4 values a
// thread, in the output's order
__global__ void cast_heads_kernel(const float* __restrict__ acc, bf16* __restrict__ dq, int H,
                                  int Sq, int D, long long n4, float mul) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const int d4 = D / 4;
    const long long row = i / d4;  // (b, q, h)
    const int h = (int)(row % H);
    const long long bq = row / H, b = bq / Sq, q = bq % Sq;
    const float4 v =
        reinterpret_cast<const float4*>(acc + ((b * H + h) * Sq + q) * D)[i % d4];
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dq) + 2 * i;
    o[0] = __floats2bfloat162_rn(v.x * mul, v.y * mul);
    o[1] = __floats2bfloat162_rn(v.z * mul, v.w * mul);
  }
}

int grid_for(long long n) {
  const long long blocks = (n + 255) / 256;
  return (int)(blocks < 8192 ? blocks : 8192);
}

int cast_scaled(const void* in, void* out, long long n, float mul, cudaStream_t stream) {
  cast_scaled_kernel<<<grid_for(n / 4), 256, 0, stream>>>(
      static_cast<const float*>(in), static_cast<bf16*>(out), n, mul);
  return (int)cudaGetLastError();
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq_acc, void* dk, void* dv, void* dk_acc, void* dv_acc,
           int B, int H, int Sq, int Sk, int D, long long q_bs, long long q_rs, long long k_bs,
           long long k_rs, long long v_bs, long long v_rs, long long do_bs, long long do_rs,
           int kv_group, int nsplit, int need_dq, int need_dkv, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!hop::head_map(&tq, q, B, Sq, H, D, q_bs, q_rs, BQ) ||
      !hop::head_map(&tdo, dout, B, Sq, H, D, do_bs, do_rs, BQ) ||
      !hop::head_map(&tk, k, B / kv_group, Sk, H, D, k_bs, k_rs, BK) ||
      !hop::head_map(&tv, v, B / kv_group, Sk, H, D, v_bs, v_rs, BK))
    return (int)cudaErrorInvalidValue;
  const int smem = Cfg<DP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + BK - 1) / BK, H, (B / kv_group) * nsplit);
  flash_bwd_kernel<DP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dk_acc), static_cast<float*>(dv_acc), H, Sq,
      Sk, D, kv_group, nsplit, need_dq, need_dkv, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout (B, Sq, H*D), k/v (B / kv_group, Sk, H*D) bf16 with the
// given batch / row strides (elements, unit channel stride; strides and
// bases 16-byte aligned); lse (B, H, Sq) f32 contiguous; delta (B, H, Sq)
// f32 scratch. With need_dq: dq_acc (B, H, Sq, D) f32 zeroed scratch and dq
// (B, Sq, H*D) bf16 contiguous. With need_dkv: dk / dv (B / kv_group, Sk,
// H*D) bf16 contiguous, each the f32 sum over the kv_group query batches
// of that K/V batch, which nsplit (dividing kv_group) CTAs share; with
// nsplit > 1, dk_acc / dv_acc of dk's shape in f32, zeroed. D is 40, 80 or
// 160.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* out,
                         const void* dout, const void* lse, void* delta, void* dq_acc, void* dq,
                         void* dk, void* dv, void* dk_acc, void* dv_acc, int B, int H, int Sq,
                         int Sk, int D, long long q_bs, long long q_rs, long long k_bs,
                         long long k_rs, long long v_bs, long long v_rs, long long o_bs,
                         long long o_rs, long long do_bs, long long do_rs, int kv_group,
                         int nsplit, int need_dq, int need_dkv, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 40 && D != 80 && D != 160) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * Sq * H;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), B, H, Sq, D, o_bs, o_rs, do_bs, do_rs);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
#define A3D_CASE(DW, DP)                                                                     \
  case DW:                                                                                   \
    rc = launch<DP>(q, k, v, dout, static_cast<const float*>(lse),                           \
                    static_cast<const float*>(delta), dq_acc, dk, dv, dk_acc, dv_acc, B, H, \
                    Sq, Sk, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, kv_group,   \
                    nsplit, need_dq, need_dkv, scale, s);                                    \
    break;
  switch (D) {
    A3D_CASE(40, 48)
    A3D_CASE(80, 80)
    A3D_CASE(160, 160)
  }
#undef A3D_CASE
  if (rc) return rc;
  const long long C = (long long)H * D;
  if (need_dq) {
    const long long n4 = (long long)B * Sq * C / 4;
    cast_heads_kernel<<<grid_for(n4), 256, 0, s>>>(static_cast<const float*>(dq_acc),
                                                    static_cast<bf16*>(dq), H, Sq, D, n4, scale);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  if (need_dkv && nsplit > 1) {
    const long long n = (long long)(B / kv_group) * Sk * C;
    if ((rc = cast_scaled(dk_acc, dk, n, scale, s))) return rc;
    if ((rc = cast_scaled(dv_acc, dv, n, 1.f, s))) return rc;
  }
  return 0;
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
