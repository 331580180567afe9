// Packed tiny-sequence self-attention (kernel B) for Hopper (sm_90a), bf16
// in/out.
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
// QK^T dot in f32, the softmax runs in exp2 form, other sequences of a tile
// are masked at -1e30, the row sum is floored at 1e-30, and P is normalised
// BEFORE its bf16 cast for the PV product (unlike the flash kernel, which
// divides after PV). q/k/v/out are the merged (B, S, H*D) layout; heads are
// read by stride, nothing is padded to 128 tokens or lanes.
//
// Bound on the H100: memory. The work is 4*S*D flops per token and head
// against 8*D bytes moved (q, k, v read once, out written once), about S/2
// flops per byte, far below the ~295 at which the tensor cores would bind.
// So the design keeps loads in flight while the tensor cores work:
//   * a unit is one head of a tile of 16 (S <= 16) or 32 (S = 32)
//     consecutive tokens, i.e. whole sequences. Each warp (a warp pair at
//     S = 32, each warp taking 16 query rows against all 32 keys) owns one
//     unit at a time and stages only that head's q, k and v tile, so S 32
//     at D 160 fits (63 KB for its pair);
//   * a persistent grid: a CTA takes tiles b, b + grid, ... and its warps
//     (or pairs) take the tile's heads i, i + groups, ..., so a tile's heads
//     are read at about the same time and its rows leave DRAM whole, where
//     a grid of one-warp CTAs walking (tile, head) units drifted apart and
//     read each 80-byte head slice of the 40-wide heads on its own (1.55x
//     slower at L0);
//   * each warp's own cp.async ring (16-byte copies, zero-filled past the
//     last token) keeps the next units' rows in flight while the current
//     one computes: four stages at D 40 (eight warps, 123 KB, one CTA an
//     SM), two at D 80 and 160 (about 64 KB, three CTAs an SM), from a
//     sweep of ring shapes on the H100. cp.async and not TMA: a head slice
//     is 80-320 bytes of a strided row, every warp is its own producer, and
//     a cp.async group needs no mbarrier or tensor map;
//   * both products are mma.sync m16n8k16 (m16n8k8 for D 40's last 8
//     columns, so nothing is padded to 48) on ldmatrix fragments; the
//     shared-memory rows hold an odd number of 16-byte chunks, so each
//     ldmatrix phase touches 8 distinct bank groups;
//   * the scores stay in the accumulator registers: the mask, the exp2
//     softmax (row max and sum over the quad by shuffles) and the
//     normalisation run there, and the bf16 P is repacked in registers as
//     the A operand of the PV product; the output goes from its
//     accumulators straight to global memory, an n-tile pair at a time
//     (8-byte stores after one shuffle), so no score, P or O passes
//     through shared memory.
// The copies, fragment loads, products, softmax and stores are shared with
// the backward, kernel E (packed_common.cuh).
//
// Padded sequences (PAD): a length that does not divide 128 (the 25-frame
// temporal attention of the Stable Video Diffusion UNet, 64-wide heads)
// takes one sequence a 32-row tile. Its S rows are read, rows S..31 are
// zero-filled by the copies (nothing is read past the sequence), keys S..31
// are masked at -1e30 before the row max, so exp2 gives them exactly 0 and
// they add nothing to the row sum or to P v, and only the S query rows are
// stored. It replaces no TPU kernel (the JAX package has no such model).

#include "packed_common.cuh"

namespace {

using namespace packed;

// GPC groups a CTA (a group: one warp, or a warp pair at TS 32); each
// group has its own NST-stage ring of one head's q, k, v tile
template <int TS, int D, int GPC, int NST>
struct Cfg {
  static constexpr int WG = TS / 16;  // warps a group: one per 16 query rows
  static constexpr int THREADS = GPC * WG * 32;
  static constexpr int CH = D / 8;                          // 16-byte chunks of a head row
  static constexpr int RS = (CH % 2 ? CH : CH + 1) * 8;    // shared row stride, elements
  static constexpr int TILE = TS * RS;                      // one of q, k, v
  static constexpr int STAGE = 3 * TILE;
  static constexpr size_t SMEM = (size_t)GPC * NST * STAGE * sizeof(bf16);
  static constexpr int NT = TS / 8;   // score n-tiles (keys)
  static constexpr int NO = D / 8;    // output n-tiles
};

// The padded softmax: as softmax_rows (packed_common.cuh), with keys at or
// past the sequence's length S masked instead of keys of other sequences.
template <int NT>
__device__ __forceinline__ void softmax_rows_padded(float (&s)[NT][4], int S, int tq,
                                                    float scale_log2, float& la, float& lb) {
  float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mask = j * 8 + 2 * tq + e < S ? 0.f : -1e30f;
      s[j][e] = s[j][e] * scale_log2 + mask;
      s[j][2 + e] = s[j][2 + e] * scale_log2 + mask;
      mxa = fmaxf(mxa, s[j][e]);
      mxb = fmaxf(mxb, s[j][2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
  }
  float suma = 0.f, sumb = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = exp2f(s[j][e] - mxa);
      s[j][2 + e] = exp2f(s[j][2 + e] - mxb);
      suma += s[j][e];
      sumb += s[j][2 + e];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    suma += __shfl_xor_sync(0xffffffffu, suma, off);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, off);
  }
  la = fmaxf(suma, 1e-30f);
  lb = fmaxf(sumb, 1e-30f);
}

// A CTA takes tiles b, b + gridDim.x, ...; in each, group i takes heads
// i, i + GPC, ...: the CTA's groups read the heads of one tile at about the
// same time, so the tile's rows leave DRAM whole. With PAD a tile is one
// sequence of S < TS tokens (from token tile * S).
template <int TS, int D, int GPC, int NST, bool PAD>
__global__ void __launch_bounds__(Cfg<TS, D, GPC, NST>::THREADS)
    packed_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int T, int S,
                       int H, long long q_ld, long long k_ld, long long v_ld, long long o_ld,
                       float scale_log2) {
  using C = Cfg<TS, D, GPC, NST>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = warp / C::WG, wq = warp % C::WG;  // group, its query-row block
  const int gtid = tid - gi * C::WG * 32;
  if (gi >= H) return;  // no head for this group (fewer heads than groups)
  const int nh = (H - 1 - gi) / GPC + 1;  // heads of this group in each tile
  const int tiles = PAD ? T / S : (T + TS - 1) / TS;
  const int sh = __ffs(S) - 1;  // S is a power of two (unless PAD)
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + gi * NST * C::STAGE;

  auto group_sync = [&]() {
    if (C::WG == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gi), "n"(C::WG * 32) : "memory");
  };
  // the group's j-th unit: (first token, head), or false past the last tile
  auto unit = [&](int j, int& t0, int& h) {
    const int ti = j / nh, tile = blockIdx.x + ti * gridDim.x;
    t0 = tile * (PAD ? S : TS);
    h = gi + (j - ti * nh) * GPC;
    return tile < tiles;
  };
  // q, k, v rows of head h of the tile at t0 into stage st
  auto load = [&](int t0, int h, int st) {
    bf16* dst = ring + st * C::STAGE;
#pragma unroll 4
    for (int i = gtid; i < 3 * TS * C::CH; i += C::WG * 32) {
      const int m = i / (TS * C::CH), rem = i - m * (TS * C::CH);
      const int r = rem / C::CH, c = rem - r * C::CH;
      const int t = t0 + r;
      const bf16* base = m == 0 ? q : (m == 1 ? k : v);
      const long long ld = m == 0 ? q_ld : (m == 1 ? k_ld : v_ld);
      const bool ok = PAD ? r < S : t < T;
      cp_async16(dst + m * C::TILE + r * C::RS + c * 8,
                 base + (ok ? (long long)t * ld + (long long)h * D + c * 8 : 0), ok);
    }
  };

  const int tq = lane & 3;
  const int ra = wq * 16 + (lane >> 2), rb = ra + 8;  // this thread's two query rows in the tile

#pragma unroll 1
  for (int j = 0; j < NST - 1; ++j) {  // the ring's first NST - 1 units
    int t0, h;
    if (unit(j, t0, h)) load(t0, h, j);
    cp_async_commit();
  }
  for (int it = 0;; ++it) {
    int t0, h;
    if (!unit(it, t0, h)) break;
    {
      int t0n, hn;
      if (unit(it + NST - 1, t0n, hn)) load(t0n, hn, (it + NST - 1) % NST);
      cp_async_commit();
    }
    cp_async_wait<NST - 1>();  // this unit's group of copies has landed
    group_sync();

    const bf16* sq = ring + (it % NST) * C::STAGE;
    const bf16* sk = sq + C::TILE;
    const bf16* sv = sk + C::TILE;
    const int ta = t0 + ra, tb = t0 + rb;
    const bool va = PAD ? ra < S : ta < T, vb = PAD ? rb < S : tb < T;

    // scores: s[j] holds rows ra (0, 1) and rb (2, 3), keys 8j + 2tq + (0, 1)
    float s[C::NT][4];
    mma_abt<TS, D, C::RS>(s, sq, sk, wq * 16, lane);
    // softmax over each row's keys of its own sequence, in registers
    float la, lb;
    if (PAD)
      softmax_rows_padded<C::NT>(s, S, tq, scale_log2, la, lb);
    else
      softmax_rows<C::NT>(s, ra, rb, sh, tq, scale_log2, la, lb);
    // P normalised, then cast: key tiles 2kk and 2kk + 1 form the A operand of key step kk
    uint32_t p[TS / 16][4];
#pragma unroll
    for (int kk = 0; kk < TS / 16; ++kk) {
      p[kk][0] = pack_bf16(s[2 * kk][0] / la, s[2 * kk][1] / la);
      p[kk][1] = pack_bf16(s[2 * kk][2] / lb, s[2 * kk][3] / lb);
      p[kk][2] = pack_bf16(s[2 * kk + 1][0] / la, s[2 * kk + 1][1] / la);
      p[kk][3] = pack_bf16(s[2 * kk + 1][2] / lb, s[2 * kk + 1][3] / lb);
    }

    // o = P v, an n-tile pair at a time, from its accumulators straight to
    // global memory
    bf16* oa = out + (long long)ta * o_ld + (long long)h * D;
    bf16* ob = out + (long long)tb * o_ld + (long long)h * D;
#pragma unroll
    for (int np = 0; np < C::NO / 2; ++np) {
      float o[2][4] = {};
      mma_ab_pair<TS, C::RS, false>(o, p, sv, 2 * np, lane);
      store_pair(oa, ob, va, vb, o[0], o[1], np * 16, tq, 1.f);
    }
    if (C::NO % 2) {
      float o[2][4] = {};
      mma_ab_pair<TS, C::RS, true>(o, p, sv, C::NO - 1, lane);
      store_one(oa, ob, va, vb, o[0], (C::NO - 1) * 8, tq, 1.f);
    }

    group_sync();  // the stage is free for the next load
  }
}

template <int TS, int D, int GPC, int NST, bool PAD = false>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           long long q_ld, long long k_ld, long long v_ld, long long o_ld, float scale,
           cudaStream_t stream) {
  using C = Cfg<TS, D, GPC, NST>;
  static int resident = 0;  // CTAs the card holds at once: the persistent grid's size
  if (!resident) {
    auto kern = packed_attn_kernel<TS, D, GPC, NST, PAD>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)C::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    int per_sm = 0, dev = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, C::THREADS, C::SMEM);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  const int T = B * S;
  const int tiles = PAD ? B : (T + TS - 1) / TS;
  if (tiles == 0 || H == 0) return 0;
  packed_attn_kernel<TS, D, GPC, NST, PAD><<<tiles < resident ? tiles : resident, C::THREADS, C::SMEM,
                                   stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), T, S, H, q_ld, k_ld, v_ld, o_ld, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// groups a CTA and stages a ring, from a sweep on the H100 (PERF.md): at D 40
// eight warps (four pairs at S 32) of four-stage rings, 123 KB, one CTA an SM
// with three units in flight a group; at D 80 and 160 two-stage rings of
// about 64 KB a CTA, three CTAs an SM
template <int TS>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
             int D, long long q_ld, long long k_ld, long long v_ld, long long o_ld,
             float scale, cudaStream_t s) {
  constexpr int G = 32 / TS;  // 2 at TS 16, 1 at TS 32
  if (D == 40)
    return launch<TS, 40, 4 * G, 4>(q, k, v, out, B, S, H, q_ld, k_ld, v_ld, o_ld, scale, s);
  if (D == 80)
    return launch<TS, 80, 2 * G, 2>(q, k, v, out, B, S, H, q_ld, k_ld, v_ld, o_ld, scale, s);
  if (D == 160)
    return launch<TS, 160, G, 2>(q, k, v, out, B, S, H, q_ld, k_ld, v_ld, o_ld, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/out: (B, S, H*D) bf16 with token stride *_ld (elements, a multiple
// of 8); S in {1, 2, 4, 8, 16, 32} (at S 1 the softmax is the constant 1:
// out is v's bits) at D in {40, 80, 160}, or S in 17..31 padded to 32 at D
// 64 (two-warp groups, two groups and three stages a CTA: 83 KB, two CTAs
// an SM; not swept).
extern "C" int packed_attn(const void* q, const void* k, const void* v, void* out, int B,
                           int S, int H, int D, long long q_ld, long long k_ld,
                           long long v_ld, long long o_ld, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return S > 16 && S < 32 ? launch<32, 64, 2, 3, true>(q, k, v, out, B, S, H, q_ld, k_ld,
                                                         v_ld, o_ld, scale, s)
                            : (int)cudaErrorInvalidValue;
  if (S == 1 || S == 2 || S == 4 || S == 8 || S == 16)
    return dispatch<16>(q, k, v, out, B, S, H, D, q_ld, k_ld, v_ld, o_ld, scale, s);
  if (S == 32) return dispatch<32>(q, k, v, out, B, S, H, D, q_ld, k_ld, v_ld, o_ld, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* packed_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
