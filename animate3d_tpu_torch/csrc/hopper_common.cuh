// Hopper (sm_90a) building blocks of the warp-specialised kernels
// (flash_fwd.cu, flash_bwd.cu, geglu.cu): mbarriers, TMA tile loads, wgmma
// fences and matrix descriptors, named barriers, register reallocation, and
// the host side's tensor maps: over the merged-head (B, S, H*D) layout of
// the attention kernels, and over row-major 2-D matrices for the GEMMs.
//
// The attention kernels' tiles use the 32-byte swizzle (head widths 40, 80
// and 160 are no multiple of 64 columns); the GEMM's operands, whose depth
// is a multiple of 64, use the 128-byte swizzle (below).
//
// The attention kernels' shared-memory tiles: a tile of `rows`
// rows and DP (a multiple of 16) head columns is stored as DP / 16 column
// chunks, each `rows` x 32 bytes (16 bf16 a row), as TMA writes a
// (16, 1, rows, 1) box of the 4-D map (D, H, S, B) under
// CU_TENSOR_MAP_SWIZZLE_32B: within each 256-byte group of 8 rows, rows 4-7
// have their two 16-byte halves swapped (byte-address bit 4 ^= bit 7). The
// columns past D (40 -> 48) are the map's out-of-bound zero fill. A chunk
// is a K-major wgmma operand (rows on M or N, 16 columns of depth) with the
// 8-row groups 256 bytes apart, and a run of 16 rows of all chunks is an
// MN-major operand (rows as the depth, columns on N) whose 16-column groups
// lie one chunk apart.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// one (16, 1, rows, 1) box of a 4-D map at (column, head, row, batch) into
// shared memory; completion adds its bytes to `bar`'s transaction count
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// one (64, rows) box of a 2-D row-major map at (column, row): `rows` rows of
// 64 bf16 (128 bytes) under the 128-byte swizzle (16-byte chunk c of row r
// stored at chunk c ^ (r % 8)); rows past the map's end read as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy shared-memory writes made visible to wgmma / TMA reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma's issue or wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// matrix descriptor of a 32-byte-swizzled operand at `p`: leading and
// stride byte offsets as the module note describes (K-major: stride = 256
// between 8-row groups, leading unused; MN-major: leading = the chunk
// stride, stride = 256 between 8-row groups of the depth)
__device__ __forceinline__ uint64_t sw32_desc(const void* p, unsigned lead, unsigned stride) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32) | (3ull << 62);
}

// matrix descriptor of a K-major operand under the 128-byte swizzle at `p`
// (a 1024-byte aligned box of tma_load_2d, plus 32 bytes for each k-step of
// 16 columns into it): 8-row groups 1024 bytes apart, the leading offset
// unused (the 16-column depth of one wgmma lies inside one 128-byte row)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// byte offset of element (row, col) of a 32-byte-swizzled chunked tile of
// `rows` rows (see the module note); col even, for a 4-byte store
__device__ __forceinline__ int sw32_offset(int row, int col, int rows) {
  return (col >> 4) * rows * 32 + row * 32 + (((col & 15) * 2) ^ (((row >> 2) & 1) << 4));
}

// ---- warps ----------------------------------------------------------------

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// the dynamic shared memory, rounded up to a 1024-byte boundary (callers
// allocate 1 KB more than they use)
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// ---- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// nothing links against libcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 4-D map (D, H, S, B) of a merged-head bf16 tensor with batch / row
// strides bs / rs (elements, unit channel stride), read in (16, 1, rows, 1)
// boxes under the 32-byte swizzle; columns past D read as zeros
inline bool head_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                     long long bs, long long rs, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  if (B == 1) bs = (long long)S * rs;  // a size-1 dimension's stride is arbitrary
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)rs * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// the 2-D map of a row-major bf16 matrix (rows, cols) with unit column
// stride, read in (64, box_rows) boxes under the 128-byte swizzle; cols %
// 64 == 0 and the base 16-byte aligned; rows past `rows` read as zeros
inline bool matrix_map(CUtensorMap* map, const void* base, long long rows, int cols,
                       int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace hop
