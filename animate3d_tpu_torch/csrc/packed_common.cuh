// Device code shared by the packed tiny-sequence attention kernels, B
// (packed_attn.cu) and its backward E (packed_attn_bwd.cu): cp.async
// copies, ldmatrix fragment loads, mma.sync products, the masked exp2
// softmax of a score tile in registers, and the 8-byte stores of an output
// n-tile pair straight from its accumulators.
//
// Tiles sit in shared memory as rows of stride RS elements (an odd number
// of 16-byte chunks, so each ldmatrix phase touches 8 distinct bank
// groups). Fragment layouts are those of mma.sync m16n8k16: a thread with
// lane = 4 g + tq holds, of a 16 x 8 accumulator tile, rows g and g + 8 at
// columns 2 tq and 2 tq + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace packed {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: m16n8k8
__device__ __forceinline__ void mma8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc (16 x TS) = A B^T over D columns: A the 16 rows of `a` from row r0,
// B the TS rows of `b`, both at row stride RS. The D % 16 == 8 tail (D 40)
// is one m16n8k8 step, so nothing is padded to 48.
template <int TS, int D, int RS>
__device__ __forceinline__ void mma_abt(float (&acc)[TS / 8][4], const bf16* a, const bf16* b,
                                        int r0, int lane) {
#pragma unroll
  for (int j = 0; j < TS / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t f[4];
    ldsm_x4(f, a + (r0 + (lane & 15)) * RS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < TS / 16; ++np) {
      uint32_t g[4];
      ldsm_x4(g, b + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS + ks * 16 +
                     ((lane >> 3) & 1) * 8);
      mma16(acc[2 * np], f, g[0], g[1]);
      mma16(acc[2 * np + 1], f, g[2], g[3]);
    }
  }
  if (D % 16) {
    uint32_t f[2];
    ldsm_x2(f, a + (r0 + (lane & 15)) * RS + (D / 16) * 16);
#pragma unroll
    for (int np = 0; np < TS / 16; ++np) {
      uint32_t g[2];
      ldsm_x2(g, b + (np * 16 + (lane & 15)) * RS + (D / 16) * 16);
      mma8(acc[2 * np], f[0], f[1], g[0]);
      mma8(acc[2 * np + 1], f[0], f[1], g[1]);
    }
  }
}

// acc += A B for output n-tiles n0 and n0 + 1 (with ONE, n0 only): A the
// 16 x TS operand in fragments a[TS / 16] (key step kk: key tiles 2 kk and
// 2 kk + 1), B the TS rows of `b` (row stride RS) read by ldmatrix.trans.
template <int TS, int RS, bool ONE>
__device__ __forceinline__ void mma_ab_pair(float (&acc)[2][4], const uint32_t (&a)[TS / 16][4],
                                            const bf16* b, int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < TS / 16; ++kk) {
    if (ONE) {
      uint32_t f[2];
      ldsm_x2_t(f, b + (kk * 16 + (lane & 15)) * RS + n0 * 8);
      mma16(acc[0], a[kk], f[0], f[1]);
    } else {
      uint32_t f[4];
      ldsm_x4_t(f, b + (kk * 16 + (lane & 15)) * RS + n0 * 8 + (lane >> 4) * 8);
      mma16(acc[0], a[kk], f[0], f[1]);
      mma16(acc[1], a[kk], f[2], f[3]);
    }
  }
}

// The masked exp2 softmax of a score tile in registers, unnormalised: s[j]
// holds rows ra (0, 1) and rb (2, 3) at keys 8 j + 2 tq + (0, 1); scores
// are scaled by scale_log2 after the dot, keys of other sequences (S = 2^sh
// tokens each) masked at -1e30, the row max and sum taken over the quad by
// shuffles. Returns the row sums floored at 1e-30 in la, lb.
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4], int ra, int rb, int sh, int tq,
                                             float scale_log2, float& la, float& lb) {
  float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = j * 8 + 2 * tq + e;
      s[j][e] = s[j][e] * scale_log2 + ((ra >> sh) == (col >> sh) ? 0.f : -1e30f);
      s[j][2 + e] = s[j][2 + e] * scale_log2 + ((rb >> sh) == (col >> sh) ? 0.f : -1e30f);
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

// Output n-tiles x (columns c0 .. c0 + 7) and y (c0 + 8 .. c0 + 15) of rows
// pa and pb (head-slice pointers; a row is stored where its flag is set),
// times mul, as bf16: lanes 2i and 2i + 1 swap halves of the two n-tiles,
// so each writes 4 consecutive columns (8 bytes). Every lane must call it.
__device__ __forceinline__ void store_pair(bf16* pa, bf16* pb, bool va, bool vb,
                                           const float* x, const float* y, int c0, int tq,
                                           float mul) {
  const bool odd = tq & 1;
  const uint32_t xa = pack_bf16(x[0] * mul, x[1] * mul), ya = pack_bf16(y[0] * mul, y[1] * mul);
  const uint32_t xb = pack_bf16(x[2] * mul, x[3] * mul), yb = pack_bf16(y[2] * mul, y[3] * mul);
  const uint32_t ga = __shfl_xor_sync(0xffffffffu, odd ? xa : ya, 1);
  const uint32_t gb = __shfl_xor_sync(0xffffffffu, odd ? xb : yb, 1);
  const int col = c0 + (odd ? 8 + 2 * tq - 2 : 2 * tq);
  if (va) *reinterpret_cast<uint2*>(pa + col) = odd ? make_uint2(ga, ya) : make_uint2(xa, ga);
  if (vb) *reinterpret_cast<uint2*>(pb + col) = odd ? make_uint2(gb, yb) : make_uint2(xb, gb);
}

// One output n-tile x (columns c0 .. c0 + 7; D 40's last), 4-byte stores.
__device__ __forceinline__ void store_one(bf16* pa, bf16* pb, bool va, bool vb, const float* x,
                                          int c0, int tq, float mul) {
  const int col = c0 + 2 * tq;
  if (va) *reinterpret_cast<uint32_t*>(pa + col) = pack_bf16(x[0] * mul, x[1] * mul);
  if (vb) *reinterpret_cast<uint32_t*>(pb + col) = pack_bf16(x[2] * mul, x[3] * mul);
}

}  // namespace packed
