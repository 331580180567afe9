// GEGLU feed-forward (kernel C) for Hopper (sm_90a), bf16 in/out, f32
// accumulation.
//
// Replaces: animate3d_tpu/ops/geglu.py::_geglu_kernel (via _geglu_pallas /
// geglu_ff), the diffusers GEGLU feed-forward of every spatial transformer
// and motion module:
//   y = ((x W1h^T + b1h) * gelu(x W1g^T + b1g)) W2^T + b2
// with W1 = [W1h; W1g] (2I, C) and W2 (C, I) in torch Linear layout.
//
// Two launches of one persistent, warp-specialised GEMM with two
// epilogues:
//   (1) GATED: hidden (M, I) = (x W1h^T + b1h) * gelu_erf(x W1g^T + b1g),
//       rounded once to bf16, with CUDA's exact erff (the TPU kernel used
//       the A&S 7.1.26 rational erf because Mosaic has no erf lowering);
//   (2) plain: y = hidden W2^T + b2, b2 added in f32.
// The (M, I) bf16 hidden makes one round trip through device memory (2 x
// 335 MB at the sampling L0 shape, 0.2 ms at 3.35 TB/s, overlapped with
// the tensor-core work of each launch). The TPU kernel keeps it on chip.
// Here a consumer's f32 output accumulator of 64 rows x C takes C / 2
// registers a thread, so one launch that keeps the hidden in registers
// fits at C = 320 only, with its gated products at m64n64; that variant
// measured slower than these two launches at every C = 320 shape of the
// paths (PERF.md), so it is not kept.
//
// Bound on the H100: the tensor cores (6 M C I flops against about 2 M (C +
// I) bytes: 300-2500 flops a byte at the main-path widths, above the card's
// 295). Design (hopper-kernels §1): one CTA an SM walks output tiles
// blockIdx.x, + gridDim.x, ... (persistent). Its producer warp keeps TMA
// loads of (64-deep) x and W boxes in flight through a ring of shared-memory
// stages under full / empty mbarriers; operands are K-major under the
// 128-byte swizzle. Two consumer warpgroups (setmaxnreg 232; the producer
// keeps 40) take alternate tiles of 128 rows and BN product columns, each
// with two m64nBNk16 wgmmas a k-step; a pair of named barriers orders their
// turns at the tensor cores (ping-pong), so one consumer's epilogue runs
// while the other's products do. In the GATED launch a stage holds the x box
// and two W1 boxes, hidden rows n0 .. n0 + BN/2 and gate rows I + n0 ..,
// so the hidden and gate products of one output element land in the same
// thread's accumulator registers (product columns c and c + BN/2): bias,
// gate and rounding run in registers. The epilogue stages each 64-row half
// in a padded shared-memory buffer and writes it with 16-byte stores. A
// ragged M or N reads TMA's zero fill and skips the stores past the end.

#include <math.h>

#include "hopper_common.cuh"
#include "wgmma_ops.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;  // rows of a consumer's tile: two m64 wgmmas
constexpr int BK = 64;   // depth of a stage: one 128-byte swizzle row
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// GATED: BN product columns = BN / 2 hidden + BN / 2 gate; else BN outputs
template <bool GATED, int BN>
struct Cfg {
  static constexpr int STAGES = GATED ? 5 : 4;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ON = GATED ? BN / 2 : BN;  // output columns of a tile
  static constexpr int EPI_LD = ON + 8;  // padded bf16 row: conflict-free fragment writes
  static constexpr int EPI_BYTES = 64 * EPI_LD * 2;  // one 64-row half
  static constexpr int EPI_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = EPI_OFF + 2 * EPI_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

// One 64-row half of a consumer's tile (acc: the m64 accumulator of rows
// row0 .. row0 + 63): bias, gate and bf16 rounding in registers, the bf16
// pairs into the consumer's buffer, then 16-byte stores of whole rows.
template <bool GATED, int BN>
__device__ __forceinline__ void store_half(const float (&acc)[BN / 2], bf16* buf, int bar,
                                           int tid, const bf16* __restrict__ bias,
                                           const bf16* __restrict__ gbias,
                                           bf16* __restrict__ out, int row0, int n0, int M,
                                           int N) {
  using C = Cfg<GATED, BN>;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int lr = warp * 16 + (lane >> 2);  // rows lr and lr + 8 of the half
  hop::bar_sync(bar, 128);  // the buffer's previous half is stored
#pragma unroll
  for (int i = 0; i < C::ON / 8; ++i) {
    const int col = i * 8 + 2 * t;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
    if (n0 + col < N) {
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bias + n0 + col));
      if (GATED) {
        constexpr int G = 4 * (C::ON / 8);  // the gate's n-tiles follow the hidden's
        const float2 gb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(gbias + n0 + col));
        v0 = (acc[4 * i] + b.x) * gelu_erf(acc[G + 4 * i] + gb.x);
        v1 = (acc[4 * i + 1] + b.y) * gelu_erf(acc[G + 4 * i + 1] + gb.y);
        v2 = (acc[4 * i + 2] + b.x) * gelu_erf(acc[G + 4 * i + 2] + gb.x);
        v3 = (acc[4 * i + 3] + b.y) * gelu_erf(acc[G + 4 * i + 3] + gb.y);
      } else {
        v0 = acc[4 * i] + b.x;
        v1 = acc[4 * i + 1] + b.y;
        v2 = acc[4 * i + 2] + b.x;
        v3 = acc[4 * i + 3] + b.y;
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(buf + lr * C::EPI_LD + col) = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(buf + (lr + 8) * C::EPI_LD + col) =
        __floats2bfloat162_rn(v2, v3);
  }
  hop::bar_sync(bar, 128);
  constexpr int CH = C::ON / 8;  // 16-byte chunks of a row
  for (int q = tid; q < 64 * CH; q += 128) {
    const int r = q / CH, cc = q % CH;
    const int row = row0 + r, col = n0 + cc * 8;
    if (row < M && col < N)
      *reinterpret_cast<uint4*>(out + (long long)row * N + col) =
          *reinterpret_cast<const uint4*>(buf + r * C::EPI_LD + cc * 8);
  }
}

// out (M, N) = epilogue(A (M, K) W (N, K)^T), A and W row-major bf16 read
// through the tensor maps ta / tb (GATED: tb the hidden half of W1, tg its
// gate half, each N rows). K % 64 == 0, N % 64 == 0.
template <bool GATED, int BN>
__global__ void __launch_bounds__(THREADS, 1)
geglu_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tg, const bf16* __restrict__ bias,
                  const bf16* __restrict__ gbias, bf16* __restrict__ out, int M, int N, int K) {
  using C = Cfg<GATED, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::smem_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  const int ntn = (N + C::ON - 1) / C::ON;
  const int tiles = ((M + BM - 1) / BM) * ntn;
  const int KT = K / BK;
  const int wg = threadIdx.x / 128;
  const int ntl = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;  // my tiles

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 128);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread streams every tile's k-blocks through the ring,
    // in the order the consumers take them (tile j to consumer j % 2)
    hop::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int seq = 0;
      for (int j = 0; j < ntl; ++j) {
        const int tile = blockIdx.x + j * gridDim.x;
        const int m0 = (tile / ntn) * BM, n0 = (tile % ntn) * C::ON;
        for (int kb = 0; kb < KT; ++kb, ++seq) {
          const int s = seq % C::STAGES;
          hop::mbar_wait(&empty[s], ((seq / C::STAGES) & 1) ^ 1);
          unsigned char* st = smem + s * C::STAGE;
          hop::mbar_arrive_tx(&full[s], C::STAGE);
          hop::tma_load_2d(st, &ta, &full[s], kb * BK, m0);
          hop::tma_load_2d(st + C::A_BYTES, &tb, &full[s], kb * BK, n0);
          if (GATED)
            hop::tma_load_2d(st + C::A_BYTES + C::B_BYTES / 2, &tg, &full[s], kb * BK, n0);
        }
      }
    }
    return;
  }

  hop::reg_alloc<CONSUMER_REGS>();
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  bf16* buf = reinterpret_cast<bf16*>(smem + C::EPI_OFF + c * C::EPI_BYTES);
  float acc0[BN / 2], acc1[BN / 2];

  // turn j at the tensor cores belongs to consumer j % 2: it waits at
  // barrier 1 + c and, once its products are issued, opens the next turn.
  // The order also keeps the ring's parity waits sound: a consumer waits on
  // a stage only after the stage's previous load has landed (without the
  // turns, the second consumer can pass a full barrier one phase early).
  if (c == 1) hop::bar_arrive(1, 256);
  for (int j = c; j < ntl; j += 2) {
    const int tile = blockIdx.x + j * gridDim.x;
    const int m0 = (tile / ntn) * BM, n0 = (tile % ntn) * C::ON;
    int seq = j * KT;
    hop::bar_sync(1 + c, 256);
    for (int kb = 0; kb < KT; ++kb, ++seq) {
      const int s = seq % C::STAGES;
      hop::mbar_wait(&full[s], (seq / C::STAGES) & 1);
      const unsigned char* st = smem + s * C::STAGE;
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = hop::sw128_desc(st + C::A_BYTES + kk * 32);
        Wgmma<BN>::template ss<0, 0>(acc0, hop::sw128_desc(st + kk * 32), db, kb | kk);
        Wgmma<BN>::template ss<0, 0>(acc1, hop::sw128_desc(st + 64 * 128 + kk * 32), db,
                                     kb | kk);
      }
      hop::wg_commit();
      if (kb > 0) {  // the previous stage's products are done: free it
        hop::wg_wait<1>();
        hop::mbar_arrive(&empty[(seq - 1) % C::STAGES]);
      }
    }
    if (j + 1 < ntl) hop::bar_arrive(2 - c, 256);
    hop::wg_wait<0>();
    hop::fence_regs(acc0);
    hop::fence_regs(acc1);
    hop::mbar_arrive(&empty[(seq - 1) % C::STAGES]);
    store_half<GATED, BN>(acc0, buf, 3 + c, tid, bias, gbias, out, m0, n0, M, N);
    store_half<GATED, BN>(acc1, buf, 3 + c, tid, bias, gbias, out, m0 + 64, n0, M, N);
  }
}


template <bool GATED, int BN>
int launch(const void* a, const void* w, const void* wgate, const void* bias,
           const void* gbias, void* out, int M, int N, int K, cudaStream_t stream) {
  using C = Cfg<GATED, BN>;
  if (M < 1 || K % BK != 0 || N % 64 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tg;
  const int wrows = GATED ? BN / 2 : BN;
  if (!hop::matrix_map(&ta, a, M, K, BM) || !hop::matrix_map(&tb, w, N, K, wrows) ||
      !hop::matrix_map(&tg, GATED ? wgate : w, N, K, wrows))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(geglu_gemm_kernel<GATED, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + C::ON - 1) / C::ON);
  const int grid = (int)(tiles < sms ? tiles : sms);
  geglu_gemm_kernel<GATED, BN><<<grid, THREADS, C::SMEM, stream>>>(
      ta, tb, tg, static_cast<const bf16*>(bias), static_cast<const bf16*>(gbias),
      static_cast<bf16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// hidden (M, I) = (x W1[:I]^T + b1[:I]) * gelu(x W1[I:]^T + b1[I:]);
// x (M, C), W1 (2I, C), b1 (2I,), all bf16 and row-contiguous;
// C % 64 == 0, I % 64 == 0.
extern "C" int geglu_hidden(const void* x, const void* w1, const void* b1, void* hidden, int M,
                            int C, int I, void* stream) {
  const bf16* w = static_cast<const bf16*>(w1);
  const bf16* b = static_cast<const bf16*>(b1);
  return launch<true, 128>(x, w, w + (long long)I * C, b, b + I, hidden, M, I, C,
                           static_cast<cudaStream_t>(stream));
}

// y (M, C) = hidden W2^T + b2; hidden (M, I), W2 (C, I), b2 (C,);
// C % 64 == 0, I % 64 == 0. Tiles of 160 columns where they divide C (the
// SD1.5 widths 320, 640, 1280), else of 128.
extern "C" int geglu_out(const void* hidden, const void* w2, const void* b2, void* y, int M,
                         int C, int I, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 160 == 0) return launch<false, 160>(hidden, w2, w2, b2, b2, y, M, C, I, s);
  return launch<false, 128>(hidden, w2, w2, b2, b2, y, M, C, I, s);
}


extern "C" const char* geglu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
