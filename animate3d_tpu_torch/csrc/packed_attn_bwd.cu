// Backward of the packed tiny-sequence self-attention (kernel E) for Hopper
// (sm_90a), bf16 in/out.
//
// Replaces: animate3d_tpu/ops/attention.py::_packed_padded_bwd_kernel,
// reached through packed_temporal_flash_padded's VJP (the motion modules'
// temporal attention: thousands of independent 16-frame sequences), and the
// backward of kernel F's route (attention_backend "packed_flash"), which the
// TPU computes through XLA's recompute of the packed attention.
//
// For each sequence and head, with the TPU kernel's rounding points: the
// normalised P = softmax(q k^T * scale) in f32 (scale after the dot, exp2
// form, row sum floored at 1e-30), P_bf16 = bf16(P), o = P_bf16 v recomputed
// in f32, Delta = rowsum(g o) from that recomputed o (not from the stored
// bf16 output), dS = bf16(P (g v^T - Delta)) (exactly 0 at S 1), and
//   dq = dS k * scale,   dk = dS^T q * scale,   dv = P_bf16^T g.
// The cotangent g arrives already in q's dtype, as the TPU route downcasts
// it before its kernel. Layout: the merged (B, S, H*D) q/k/v/g; heads are
// read by stride, nothing is padded to 128 tokens or lanes.
//
// Bound on the H100: memory. Per token and head it moves 7*D*2 bytes (q, k,
// v, g read; dq, dk, dv written) against about 10*S*D flops, ~S/1.4 flops
// per byte, far below the ~295 where the tensor cores bind. The design is
// kernel B's (packed_attn.cu), whose helpers it shares (packed_common.cuh):
//   * a unit is one head of a tile of 16 (S <= 16) or 32 (S = 32)
//     consecutive tokens, i.e. whole sequences, so nothing is summed across
//     units and there are no atomics: two launches are bitwise equal. A
//     group (one warp, or a warp pair at S = 32) owns one unit at a time and
//     stages only that head's q, k, v and g rows, so S 32 at D 160 fits (43
//     KB a stage);
//   * a persistent grid: a CTA takes tiles b, b + grid, ... and its groups
//     take the tile's heads, so a tile's rows leave DRAM together;
//   * each group's own cp.async ring (16-byte copies, zero-filled past the
//     last token) keeps the next units in flight while one computes;
//   * all five products are mma.sync m16n8k16 (m16n8k8 for D 40's last
//     columns) on ldmatrix fragments. A warp takes 16 query rows: the scores
//     and dP = g v^T stay in accumulator registers, where the softmax and dS
//     are formed; P_bf16 and dS are repacked in registers as the A operands
//     of o = P_bf16 v and dq = dS k. The recomputed o never leaves its
//     accumulators: each n-tile pair is folded into Delta (rowsum over the
//     quad by shuffles) as it is made. dk and dv need the transposed
//     operands dS^T and P_bf16^T over the whole tile, so each warp writes its
//     rows of P_bf16 and dS into two bf16 TS x TS slabs of its group (odd
//     16-byte chunks a row), and after the group's barrier each warp takes
//     16 key rows of dk and dv, reading the slabs by ldmatrix.trans: at S 32
//     the warps of a pair split the query rows for dq and the key rows for
//     dk and dv. No f32 scratch;
//   * dq, dk and dv are made one after another, an n-tile pair at a time,
//     so one 16 x 16 f32 accumulator pair is live at once. At D 40 and 80 a
//     warp stages each 16 x D gradient block as bf16 in a buffer of its own
//     and stores it in 16-byte pieces, whole head slices at a time: the
//     80-byte slices stored 8 bytes a lane from the accumulators held E at
//     54% of its byte bound, staged at 65%. At D 160 (320-byte slices) the
//     8-byte stores straight from the accumulators (after one shuffle) are
//     faster (PERF.md).

#include "packed_common.cuh"

namespace {

using namespace packed;

// GPC groups a CTA (a group: one warp, or a warp pair at TS 32); each group
// has its own NST-stage ring of one head's q, k, v, g tile and its P and dS
// slabs
template <int TS, int D, int GPC, int NST>
struct Cfg {
  static constexpr int WG = TS / 16;  // warps a group: one per 16 query (and key) rows
  static constexpr int THREADS = GPC * WG * 32;
  static constexpr int CH = D / 8;                        // 16-byte chunks of a head row
  static constexpr int RS = (CH % 2 ? CH : CH + 1) * 8;  // shared row stride, elements
  static constexpr int TILE = TS * RS;                    // one of q, k, v, g
  static constexpr int STAGE = 4 * TILE;
  static constexpr int SR = TS + 8;     // slab row stride: TS / 8 + 1 chunks, an odd number
  static constexpr int SLAB = TS * SR;  // one of P_bf16, dS
  static constexpr bool STG = D < 160;  // gradients staged for 16-byte stores (grad_rows)
  static constexpr int OUT = STG ? 16 * RS : 0;  // a warp's staged 16 x D gradient block
  static constexpr int GROUP = NST * STAGE + 2 * SLAB + WG * OUT;
  static constexpr size_t SMEM = (size_t)GPC * GROUP * sizeof(bf16);
  static constexpr int NT = TS / 8;  // score n-tiles (keys)
  static constexpr int NO = D / 8;   // output n-tiles
};

// A 16 x D gradient block for tokens t0 .. t0 + 15 (those below T) of the
// head slice at `out`: acc = A B an n-tile pair at a time, A in fragments a,
// B the TS rows of b, times mul. With STG, staged as bf16 in this warp's
// 16 x RS buffer and stored in 16-byte pieces, whole rows at a time (the
// 80- and 160-byte slices of D 40 and 80); else from the accumulators
// straight to global memory, 8-byte stores after one shuffle (the 320-byte
// slices of D 160, whole sectors already).
template <int TS, int D, int RS, bool STG>
__device__ __forceinline__ void grad_rows(bf16* __restrict__ out, long long ld, int h, int t0,
                                          int T, const uint32_t (&a)[TS / 16][4],
                                          const bf16* b, float mul, bf16* buf, int lane) {
  const int tq = lane & 3, ra = lane >> 2;
  bf16* pa = out + (long long)(t0 + ra) * ld + (long long)h * D;
  bf16* pb = pa + 8 * ld;
  const bool va = t0 + ra < T, vb = t0 + ra + 8 < T;
  auto put = [&](const float* x, int col) {
    *reinterpret_cast<uint32_t*>(buf + ra * RS + col) = pack_bf16(x[0] * mul, x[1] * mul);
    *reinterpret_cast<uint32_t*>(buf + (ra + 8) * RS + col) =
        pack_bf16(x[2] * mul, x[3] * mul);
  };
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    float acc[2][4] = {};
    mma_ab_pair<TS, RS, false>(acc, a, b, 2 * np, lane);
    if (STG) {
      put(acc[0], np * 16 + 2 * tq);
      put(acc[1], np * 16 + 8 + 2 * tq);
    } else {
      store_pair(pa, pb, va, vb, acc[0], acc[1], np * 16, tq, mul);
    }
  }
  if (D % 16) {
    float acc[2][4] = {};
    mma_ab_pair<TS, RS, true>(acc, a, b, D / 8 - 1, lane);
    if (STG)
      put(acc[0], (D / 8 - 1) * 8 + 2 * tq);
    else
      store_one(pa, pb, va, vb, acc[0], (D / 8 - 1) * 8, tq, mul);
  }
  if (STG) {
    __syncwarp();
    constexpr int CH = D / 8;
#pragma unroll
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = i - r * CH;
      if (t0 + r < T)
        *reinterpret_cast<uint4*>(out + (long long)(t0 + r) * ld + (long long)h * D + c * 8) =
            *reinterpret_cast<const uint4*>(buf + r * RS + c * 8);
    }
    __syncwarp();  // the buffer is free for the next block
  }
}

// The A fragments of X^T's 16 rows from m0 over all TS columns, X a TS x TS
// bf16 slab (row stride SR) read by ldmatrix.trans: register r of key step
// kk is the 8 x 8 block (rows m0 + 8 (r & 1), columns 16 kk + 8 (r >> 1)).
template <int TS, int SR>
__device__ __forceinline__ void slab_t_frags(uint32_t (&a)[TS / 16][4], const bf16* x, int m0,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < TS / 16; ++kk)
    ldsm_x4_t(a[kk], x + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * SR + m0 +
                         ((lane >> 3) & 1) * 8);
}

// A CTA takes tiles b, b + gridDim.x, ...; in each, group i takes heads
// i, i + GPC, ...
template <int TS, int D, int GPC, int NST>
__global__ void __launch_bounds__(Cfg<TS, D, GPC, NST>::THREADS)
    packed_attn_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ g,
                           bf16* __restrict__ dq, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int T, int S, int H, long long q_ld,
                           long long k_ld, long long v_ld, long long g_ld, long long d_ld,
                           float scale, float scale_log2) {
  using C = Cfg<TS, D, GPC, NST>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = warp / C::WG, wq = warp % C::WG;  // group, its row block
  const int gtid = tid - gi * C::WG * 32;
  if (gi >= H) return;  // no head for this group (fewer heads than groups)
  const int nh = (H - 1 - gi) / GPC + 1;  // heads of this group in each tile
  const int tiles = (T + TS - 1) / TS;
  const int sh = __ffs(S) - 1;  // S is a power of two
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + gi * C::GROUP;
  bf16* sp = ring + NST * C::STAGE;  // P_bf16, TS x TS
  bf16* sds = sp + C::SLAB;           // dS, TS x TS
  bf16* gbuf = sds + C::SLAB + wq * C::OUT;  // this warp's staged gradient block

  auto group_sync = [&]() {
    if (C::WG == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gi), "n"(C::WG * 32) : "memory");
  };
  // the group's j-th unit: (first token, head), or false past the last tile
  auto unit = [&](int j, int& t0, int& h) {
    const int ti = j / nh, tile = blockIdx.x + ti * gridDim.x;
    t0 = tile * TS;
    h = gi + (j - ti * nh) * GPC;
    return tile < tiles;
  };
  // q, k, v, g rows of head h of the tile at t0 into stage st
  auto load = [&](int t0, int h, int st) {
    bf16* dst = ring + st * C::STAGE;
#pragma unroll 4
    for (int i = gtid; i < 4 * TS * C::CH; i += C::WG * 32) {
      const int m = i / (TS * C::CH), rem = i - m * (TS * C::CH);
      const int r = rem / C::CH, c = rem - r * C::CH;
      const int t = t0 + r;
      const bf16* base = m == 0 ? q : (m == 1 ? k : (m == 2 ? v : g));
      const long long ld = m == 0 ? q_ld : (m == 1 ? k_ld : (m == 2 ? v_ld : g_ld));
      const bool ok = t < T;
      cp_async16(dst + m * C::TILE + r * C::RS + c * 8,
                 base + (ok ? (long long)t * ld + (long long)h * D + c * 8 : 0), ok);
    }
  };

  const int tq = lane & 3, r0 = wq * 16;
  const int ra = r0 + (lane >> 2), rb = ra + 8;  // this thread's two rows in the tile

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
    const bf16* sg = sv + C::TILE;

    // P in f32 (normalised), held in the score registers: rows ra (0, 1)
    // and rb (2, 3), keys 8j + 2tq + (0, 1)
    float s[C::NT][4];
    mma_abt<TS, D, C::RS>(s, sq, sk, r0, lane);
    float la, lb;
    softmax_rows<C::NT>(s, ra, rb, sh, tq, scale_log2, la, lb);
    uint32_t p[TS / 16][4];  // P_bf16, the A operand of key step kk
#pragma unroll
    for (int kk = 0; kk < TS / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[2 * kk][e] /= la;
        s[2 * kk][2 + e] /= lb;
        s[2 * kk + 1][e] /= la;
        s[2 * kk + 1][2 + e] /= lb;
      }
      p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // Delta = rowsum(g o), o = P_bf16 v folded in an n-tile pair at a time
    float da = 0.f, db = 0.f;
    auto fold = [&](const float (&o)[2][4], int n0, int nt) {
#pragma unroll
      for (int x = 0; x < nt; ++x) {
        const int col = (n0 + x) * 8 + 2 * tq;
        const float2 ga = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            sg + ra * C::RS + col));
        const float2 gb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            sg + rb * C::RS + col));
        da += ga.x * o[x][0] + ga.y * o[x][1];
        db += gb.x * o[x][2] + gb.y * o[x][3];
      }
    };
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      float o[2][4] = {};
      mma_ab_pair<TS, C::RS, false>(o, p, sv, 2 * np, lane);
      fold(o, 2 * np, 2);
    }
    if (D % 16) {
      float o[2][4] = {};
      mma_ab_pair<TS, C::RS, true>(o, p, sv, C::NO - 1, lane);
      fold(o, C::NO - 1, 1);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      da += __shfl_xor_sync(0xffffffffu, da, off);
      db += __shfl_xor_sync(0xffffffffu, db, off);
    }

    // dS = bf16(P (g v^T - Delta)), the A operand of dq = dS k
    float dp[C::NT][4];
    mma_abt<TS, D, C::RS>(dp, sg, sv, r0, lane);
    uint32_t ds[TS / 16][4];
#pragma unroll
    for (int kk = 0; kk < TS / 16; ++kk) {
      const float* x = s[2 * kk];
      const float* y = s[2 * kk + 1];
      const float* dx = dp[2 * kk];
      const float* dy = dp[2 * kk + 1];
      ds[kk][0] = pack_bf16(x[0] * (dx[0] - da), x[1] * (dx[1] - da));
      ds[kk][1] = pack_bf16(x[2] * (dx[2] - db), x[3] * (dx[3] - db));
      ds[kk][2] = pack_bf16(y[0] * (dy[0] - da), y[1] * (dy[1] - da));
      ds[kk][3] = pack_bf16(y[2] * (dy[2] - db), y[3] * (dy[3] - db));
    }
    if (S == 1) {  // a one-token softmax is the constant 1: dS is exactly 0 (g v^T -
                   // Delta holds only the rounding of one sum taken in two orders)
#pragma unroll
      for (int kk = 0; kk < TS / 16; ++kk) ds[kk][0] = ds[kk][1] = ds[kk][2] = ds[kk][3] = 0u;
    }
    // this warp's rows of P_bf16 and dS into the group's slabs
#pragma unroll
    for (int kk = 0; kk < TS / 16; ++kk) {
      const int c = kk * 16 + 2 * tq;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int off = ((x & 1) ? rb : ra) * C::SR + c + (x >> 1) * 8;
        *reinterpret_cast<uint32_t*>(sp + off) = p[kk][x];
        *reinterpret_cast<uint32_t*>(sds + off) = ds[kk][x];
      }
    }

    // dq = dS k
    grad_rows<TS, D, C::RS, C::STG>(dq, d_ld, h, t0 + r0, T, ds, sk, scale, gbuf, lane);
    group_sync();  // the slabs hold the whole tile

    // this warp's 16 key rows: dk = dS^T q, dv = P_bf16^T g
    uint32_t at[TS / 16][4];
    slab_t_frags<TS, C::SR>(at, sds, r0, lane);
    grad_rows<TS, D, C::RS, C::STG>(dk, d_ld, h, t0 + r0, T, at, sq, scale, gbuf, lane);
    slab_t_frags<TS, C::SR>(at, sp, r0, lane);
    grad_rows<TS, D, C::RS, C::STG>(dv, d_ld, h, t0 + r0, T, at, sg, 1.f, gbuf, lane);

    group_sync();  // the stage and the slabs are free for the next unit
  }
}

template <int TS, int D, int GPC, int NST>
int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, int B, int S, int H, long long q_ld, long long k_ld, long long v_ld,
           long long g_ld, long long d_ld, float scale, cudaStream_t stream) {
  using C = Cfg<TS, D, GPC, NST>;
  static int resident = 0;  // CTAs the card holds at once: the persistent grid's size
  if (!resident) {
    auto kern = packed_attn_bwd_kernel<TS, D, GPC, NST>;
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
  const int tiles = (T + TS - 1) / TS;
  if (tiles == 0 || H == 0) return 0;
  packed_attn_bwd_kernel<TS, D, GPC, NST>
      <<<tiles < resident ? tiles : resident, C::THREADS, C::SMEM, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(g), static_cast<bf16*>(dq),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, S, H, q_ld, k_ld, v_ld, g_ld,
          d_ld, scale, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// groups a CTA and stages a ring: kernel B's shapes, with the fourth (g)
// tile, the two slabs and the gradient buffers a group (a sweep of other
// shapes at D 40, 80 and 160 on the H100 found none faster: PERF.md)
template <int TS>
int dispatch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
             void* dv, int B, int S, int H, int D, long long q_ld, long long k_ld,
             long long v_ld, long long g_ld, long long d_ld, float scale, cudaStream_t s) {
  constexpr int G = 32 / TS;  // 2 at TS 16, 1 at TS 32
#define A3D_LAUNCH(DD, GPC, NST)                                                          \
  return launch<TS, DD, GPC, NST>(q, k, v, g, dq, dk, dv, B, S, H, q_ld, k_ld, v_ld, g_ld, \
                                  d_ld, scale, s)
  if (D == 40) A3D_LAUNCH(40, 4 * G, 4);
  if (D == 80) A3D_LAUNCH(80, 2 * G, 2);
  if (D == 160) A3D_LAUNCH(160, G, 2);
#undef A3D_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/g: (B, S, H*D) bf16 with token stride *_ld (elements, a multiple of
// 8); dq/dk/dv: (B, S, H*D) bf16 with token stride d_ld. S in {1, 2, 4, 8,
// 16, 32} (at S 1: dq = dk = 0, dv = g); D in {40, 80, 160}.
extern "C" int packed_attn_bwd(const void* q, const void* k, const void* v, const void* g,
                               void* dq, void* dk, void* dv, int B, int S, int H, int D,
                               long long q_ld, long long k_ld, long long v_ld, long long g_ld,
                               long long d_ld, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 1 || S == 2 || S == 4 || S == 8 || S == 16)
    return dispatch<16>(q, k, v, g, dq, dk, dv, B, S, H, D, q_ld, k_ld, v_ld, g_ld, d_ld, scale,
                        s);
  if (S == 32)
    return dispatch<32>(q, k, v, g, dq, dk, dv, B, S, H, D, q_ld, k_ld, v_ld, g_ld, d_ld, scale,
                        s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* packed_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
