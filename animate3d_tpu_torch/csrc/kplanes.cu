// K-planes sampler (kernel I) for Hopper (sm_90a), f32, forward and
// hand-derived backward.
//
// Replaces no TPU kernel: the JAX package samples its K-planes with plain
// jnp gathers (animate3d_tpu/gaussians/kplanes.py: grid_sample_2d,
// interpolate_ms_features), which XLA fuses on the TPU. The port's plain
// version of those gathers (animate3d_tpu_torch/gaussians/kplanes.py) costs
// on the card four indexed gathers a plane (48 a call at two scales), a
// sort-based index-put with accumulate for each in the backward, and a
// blocking upload of each plane's index list: about 19 ms of device time and
// 12 host syncs a recon step. This kernel was added for that.
//
// Function: sample_frames(xyz (N, 3), ts (F,), planes) -> (F, N, C * S),
// row (f, n) = interpolate_ms_features at the point (xyz[n], ts[f]): per
// scale s, each of the six planes (c0, c1) in itertools order (xy, xz, xt,
// yz, yt, zt; plane (H, W) = (reso[c1], reso[c0])) sampled bilinearly at
// (coord[c0], coord[c1]) with align_corners and a border clamp
// (x = clamp((u + 1) * 0.5 * (W - 1), 0, W - 1), x1 = min(x0 + 1, W - 1),
// fx = x - x0), the product over the six in that order, the scales
// concatenated. Every float operation of the forward is the plain version's,
// in its order and rounded as it rounds (__fmul_rn / __fadd_rn: no FMA
// contraction), so the features are bitwise equal to it.
//
// Bound, at the recon step (F 16, N 20,000, C 16, S 2): the features out,
// F N C S 4 = 41.0 MB, and their gradient in, 41.0 MB: 12.2 us each way at
// 3.35 TB/s. The planes (2.78 MB at the recon config) stay in L2. The
// backward adds N S (C / 4) 12 = 1.92 M 16-byte global reductions for the
// spatial planes and at most (blocks) T (R0 + R1 + R2) for the time planes
// (0.65 M at the recon shape).
//
// Design.
//   planes: one channels-last (H, W, C) copy of all 6 S planes a call
//     (kplanes_pack_kernel), so that a bilinear corner's 4 channels are one
//     16-byte load and its C channels one 64-byte line. The backward
//     accumulates into a channels-last f32 scratch of the same layout and
//     transposes it back once (kplanes_unpack_kernel).
//   forward: a block row per scale, a thread per (point, 4 channels). The
//     three spatial planes are sampled once; a loop over the F frames
//     samples only the three time planes and writes 16 bytes. The C / 4
//     threads of a point write its C floats of the scale together.
//   backward: a block row per (scale, 4 channels), a thread per point of
//     the block's range. The taps are recomputed from the L2-resident
//     planes, so nothing but the packed copy is saved. A spatial plane's
//     weights do not depend on t, so a point's spatial-plane gradients are
//     summed over the F frames in registers and scattered once
//     (red.global.add.v4.f32: 12 a point and 4 channels, not 12 F). A
//     frame's time-plane taps lie in two rows (t0, t1): the block sums all T
//     rows of its scale's three time planes for its 4 channels in shared
//     memory (cells padded to 5 floats, so that lanes at neighbouring
//     columns fall in different banks) and flushes the non-zero cells once
//     with the same 16-byte reductions. A layout whose time rows do not
//     fit in a block's shared memory is refused (ops/kplanes.py checks it
//     first; at the configs' grids they need at most 96 KB).
//   The gradient's sums meet by f32 atomics, in an order that changes from
//   run to run.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SCALES = 4;
constexpr int NPLANE = 6;
constexpr int MAX_PLANES = MAX_SCALES * NPLANE;
constexpr int THREADS = 256;
constexpr int CELL = 5;               // floats a shared cell: 4 channels + 1 of padding
constexpr int SMEM_MAX = 232448;      // a block's dynamic shared memory on the H100
constexpr int BLOCKS_PER_SM = 2;      // backward blocks the grid aims at a SM

// the axes (c0, c1) of each plane: itertools.combinations(range(4), 2)
constexpr int kC0[NPLANE] = {0, 0, 0, 1, 1, 2};
constexpr int kC1[NPLANE] = {1, 2, 3, 2, 3, 3};

struct Geom {
  int scales, C, Q, nplanes;          // Q = C / 4
  int reso[MAX_SCALES][4];            // per scale: x, y, z, t
  int h[MAX_PLANES], w[MAX_PLANES];   // plane k = s * 6 + p
  long long off[MAX_PLANES + 1];      // float offset of plane k; off[nplanes] = total
};

struct Sources {
  const float* p[MAX_PLANES];         // (C, H, W) each
};

// one axis' bilinear tap: cells i0, i1 and weights g = 1 - f, f
struct Tap {
  int i0, i1;
  float f, g;
};

__device__ __forceinline__ Tap axis_tap(float u, int r) {
  const float hi = static_cast<float>(r - 1);
  float x = __fmul_rn(__fmul_rn(__fadd_rn(u, 1.0f), 0.5f), hi);
  x = fminf(fmaxf(x, 0.0f), hi);
  Tap t;
  t.i0 = min(max(static_cast<int>(floorf(x)), 0), r - 1);
  t.i1 = min(t.i0 + 1, r - 1);
  t.f = __fsub_rn(x, static_cast<float>(t.i0));
  t.g = __fsub_rn(1.0f, t.f);
  return t;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 mul(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 mul(float4 a, float b) {
  return make_float4(__fmul_rn(a.x, b), __fmul_rn(a.y, b), __fmul_rn(a.z, b), __fmul_rn(a.w, b));
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ long long cell(const Tap& ax, const Tap& ay, int W, bool x1, bool y1) {
  return static_cast<long long>(y1 ? ay.i1 : ay.i0) * W + (x1 ? ax.i1 : ax.i0);
}

// (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy
// of 4 channels at plane + q * 4 (channels-last, row width W, C channels)
__device__ __forceinline__ float4 sample(const float* plane, int W, int C, const Tap& ax,
                                         const Tap& ay) {
  const float4 c00 = ld4(plane + cell(ax, ay, W, false, false) * C);
  const float4 c01 = ld4(plane + cell(ax, ay, W, true, false) * C);
  const float4 c10 = ld4(plane + cell(ax, ay, W, false, true) * C);
  const float4 c11 = ld4(plane + cell(ax, ay, W, true, true) * C);
  const float4 top = add(mul(c00, ax.g), mul(c01, ax.f));
  const float4 bot = add(mul(c10, ax.g), mul(c11, ax.f));
  return add(mul(top, ay.g), mul(bot, ay.f));
}

__device__ __forceinline__ void red4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);  // red.global.add.v4.f32
}

// the bilinear backward of ``sample``: gradient g of the 4 channels onto the
// four corners in global memory (a row whose weight is 0 adds nothing)
__device__ __forceinline__ void splat_global(float* plane, int W, int C, const Tap& ax,
                                             const Tap& ay, float4 g) {
  if (ay.g != 0.0f) {
    const float4 top = mul(g, ay.g);
    red4(plane + cell(ax, ay, W, false, false) * C, mul(top, ax.g));
    red4(plane + cell(ax, ay, W, true, false) * C, mul(top, ax.f));
  }
  if (ay.f != 0.0f) {
    const float4 bot = mul(g, ay.f);
    red4(plane + cell(ax, ay, W, false, true) * C, mul(bot, ax.g));
    red4(plane + cell(ax, ay, W, true, true) * C, mul(bot, ax.f));
  }
}

__device__ __forceinline__ void add_cell(float* c, float4 v) {
  atomicAdd(c, v.x);
  atomicAdd(c + 1, v.y);
  atomicAdd(c + 2, v.z);
  atomicAdd(c + 3, v.w);
}

// the same into a time plane's rows in shared memory (cells of CELL floats)
__device__ __forceinline__ void splat_shared(float* region, int W, const Tap& ax, const Tap& ay,
                                             float4 g) {
  if (ay.g != 0.0f) {
    const float4 top = mul(g, ay.g);
    add_cell(region + cell(ax, ay, W, false, false) * CELL, mul(top, ax.g));
    add_cell(region + cell(ax, ay, W, true, false) * CELL, mul(top, ax.f));
  }
  if (ay.f != 0.0f) {
    const float4 bot = mul(g, ay.f);
    add_cell(region + cell(ax, ay, W, false, true) * CELL, mul(bot, ax.g));
    add_cell(region + cell(ax, ay, W, true, true) * CELL, mul(bot, ax.f));
  }
}

__device__ __forceinline__ int plane_of(const Geom& g, long long e) {
  int k = 0;
  while (k + 1 < g.nplanes && e >= g.off[k + 1]) ++k;
  return k;
}

// (C, H, W) planes -> one channels-last buffer, plane k at off[k]
__global__ void __launch_bounds__(THREADS) kplanes_pack_kernel(Geom g, Sources src,
                                                               float* __restrict__ dst) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= g.off[g.nplanes]) return;
  const int k = plane_of(g, e);
  const long long l = e - g.off[k];  // (y W + x) C + c
  const long long hw = static_cast<long long>(g.h[k]) * g.w[k];
  dst[e] = __ldg(src.p[k] + (l % g.C) * hw + l / g.C);
}

// channels-last gradient scratch -> (C, H, W) planes in one flat buffer
__global__ void __launch_bounds__(THREADS) kplanes_unpack_kernel(Geom g,
                                                                 const float* __restrict__ src,
                                                                 float* __restrict__ dst) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= g.off[g.nplanes]) return;
  const int k = plane_of(g, e);
  const long long l = e - g.off[k];  // c H W + y W + x
  const long long hw = static_cast<long long>(g.h[k]) * g.w[k];
  dst[e] = src[g.off[k] + (l % hw) * g.C + l / hw];
}

__global__ void __launch_bounds__(THREADS) kplanes_fwd_kernel(Geom g,
                                                              const float* __restrict__ packed,
                                                              const float* __restrict__ xyz,
                                                              const float* __restrict__ ts,
                                                              int n_pts, int n_frames,
                                                              float* __restrict__ out) {
  const int s = blockIdx.y, C = g.C, Q = g.Q;
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= static_cast<long long>(n_pts) * Q) return;
  const int n = static_cast<int>(t / Q), q = static_cast<int>(t % Q);
  const int r0 = g.reso[s][0], r1 = g.reso[s][1], r2 = g.reso[s][2], rt = g.reso[s][3];
  const float* pl = packed + q * 4;
  const float* p0 = pl + g.off[s * NPLANE + 0];
  const float* p1 = pl + g.off[s * NPLANE + 1];
  const float* p2 = pl + g.off[s * NPLANE + 2];
  const float* p3 = pl + g.off[s * NPLANE + 3];
  const float* p4 = pl + g.off[s * NPLANE + 4];
  const float* p5 = pl + g.off[s * NPLANE + 5];
  const Tap a0 = axis_tap(__ldg(xyz + 3ll * n), r0);
  const Tap a1 = axis_tap(__ldg(xyz + 3ll * n + 1), r1);
  const Tap a2 = axis_tap(__ldg(xyz + 3ll * n + 2), r2);
  const float4 f0 = sample(p0, r0, C, a0, a1);
  const float4 f1 = sample(p1, r0, C, a0, a2);
  const float4 f3 = sample(p3, r1, C, a1, a2);
  const float4 p01 = mul(f0, f1);
  const long long row = static_cast<long long>(C) * g.scales;
  float* o = out + n * row + s * C + q * 4;
  for (int f = 0; f < n_frames; ++f) {
    const Tap at = axis_tap(__ldg(ts + f), rt);
    const float4 f2 = sample(p2, r0, C, a0, at);
    const float4 f4 = sample(p4, r1, C, a1, at);
    const float4 f5 = sample(p5, r2, C, a2, at);
    // the plain version's order: ((((f0 f1) f2) f3) f4) f5
    *reinterpret_cast<float4*>(o + static_cast<long long>(f) * n_pts * row) =
        mul(mul(mul(mul(p01, f2), f3), f4), f5);
  }
}

__global__ void __launch_bounds__(THREADS) kplanes_bwd_kernel(Geom g,
                                                              const float* __restrict__ packed,
                                                              const float* __restrict__ xyz,
                                                              const float* __restrict__ ts,
                                                              const float* __restrict__ gout,
                                                              int n_pts, int n_frames,
                                                              int per_block,
                                                              float* __restrict__ grad) {
  extern __shared__ float acc[];  // time planes xt, yt, zt: (T, R_a) cells of CELL floats
  const int s = blockIdx.y / g.Q, q = blockIdx.y % g.Q, C = g.C;
  const int r0 = g.reso[s][0], r1 = g.reso[s][1], r2 = g.reso[s][2], rt = g.reso[s][3];
  const long long o0 = g.off[s * NPLANE + 0], o1 = g.off[s * NPLANE + 1];
  const long long o2 = g.off[s * NPLANE + 2], o3 = g.off[s * NPLANE + 3];
  const long long o4 = g.off[s * NPLANE + 4], o5 = g.off[s * NPLANE + 5];
  const int base1 = rt * r0, base2 = base1 + rt * r1, cells = base2 + rt * r2;
  float* acc0 = acc;
  float* acc1 = acc + base1 * CELL;
  float* acc2 = acc + base2 * CELL;
  for (int i = threadIdx.x; i < cells * CELL; i += THREADS) acc[i] = 0.0f;
  __syncthreads();
  const float* pl = packed + q * 4;
  float* gq = grad + q * 4;
  const long long row = static_cast<long long>(C) * g.scales;
  const int col = s * C + q * 4;
  const int lo = blockIdx.x * per_block, hi = min(n_pts, lo + per_block);
  for (int n = lo + threadIdx.x; n < hi; n += THREADS) {
    const Tap a0 = axis_tap(__ldg(xyz + 3ll * n), r0);
    const Tap a1 = axis_tap(__ldg(xyz + 3ll * n + 1), r1);
    const Tap a2 = axis_tap(__ldg(xyz + 3ll * n + 2), r2);
    const float4 f0 = sample(pl + o0, r0, C, a0, a1);
    const float4 f1 = sample(pl + o1, r0, C, a0, a2);
    const float4 f3 = sample(pl + o3, r1, C, a1, a2);
    const float4 p01 = mul(f0, f1);
    float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0, g3 = g0;
    for (int f = 0; f < n_frames; ++f) {
      const Tap at = axis_tap(__ldg(ts + f), rt);
      const float4 f2 = sample(pl + o2, r0, C, a0, at);
      const float4 f4 = sample(pl + o4, r1, C, a1, at);
      const float4 f5 = sample(pl + o5, r2, C, a2, at);
      const float4 go = ld4(gout + (static_cast<long long>(f) * n_pts + n) * row + col);
      // the chain rule through ((((f0 f1) f2) f3) f4) f5, as autograd takes it
      const float4 p2 = mul(p01, f2), p3 = mul(p2, f3), p4 = mul(p3, f4);
      const float4 gp4 = mul(go, f5), gf5 = mul(go, p4);
      const float4 gp3 = mul(gp4, f4), gf4 = mul(gp4, p3);
      const float4 gp2 = mul(gp3, f3), gf3 = mul(gp3, p2);
      const float4 gp1 = mul(gp2, f2), gf2 = mul(gp2, p01);
      g0 = add(g0, mul(gp1, f1));
      g1 = add(g1, mul(gp1, f0));
      g3 = add(g3, gf3);
      splat_shared(acc0, r0, a0, at, gf2);
      splat_shared(acc1, r1, a1, at, gf4);
      splat_shared(acc2, r2, a2, at, gf5);
    }
    splat_global(gq + o0, r0, C, a0, a1, g0);
    splat_global(gq + o1, r0, C, a0, a2, g1);
    splat_global(gq + o3, r1, C, a1, a2, g3);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += THREADS) {
    const float* c = acc + i * CELL;
    const float4 v = make_float4(c[0], c[1], c[2], c[3]);
    if (v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f) continue;
    // cell i - base is (t R_a + x), the same index in the channels-last plane
    const long long at = i < base1 ? o2 + static_cast<long long>(i) * C
                         : i < base2 ? o4 + static_cast<long long>(i - base1) * C
                                     : o5 + static_cast<long long>(i - base2) * C;
    red4(gq + at, v);
  }
}

int make_geom(const int* reso, int scales, int C, Geom* g) {
  if (scales < 1 || scales > MAX_SCALES || C < 4 || C % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  g->scales = scales;
  g->C = C;
  g->Q = C / 4;
  g->nplanes = scales * NPLANE;
  long long off = 0;
  for (int s = 0; s < scales; ++s) {
    for (int a = 0; a < 4; ++a) {
      if (reso[s * 4 + a] < 1) return static_cast<int>(cudaErrorInvalidValue);
      g->reso[s][a] = reso[s * 4 + a];
    }
    for (int p = 0; p < NPLANE; ++p) {
      const int k = s * NPLANE + p;
      g->h[k] = reso[s * 4 + kC1[p]];
      g->w[k] = reso[s * 4 + kC0[p]];
      g->off[k] = off;
      off += static_cast<long long>(C) * g->h[k] * g->w[k];
    }
  }
  g->off[g->nplanes] = off;
  return 0;
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

size_t shared_bytes(const Geom& g) {
  size_t most = 0;
  for (int s = 0; s < g.scales; ++s) {
    const int* r = g.reso[s];
    const size_t b = static_cast<size_t>(r[3]) * (r[0] + r[1] + r[2]) * CELL * sizeof(float);
    most = b > most ? b : most;
  }
  return most;
}

// The SM count and the backward's shared-memory limit, set once a process
// (the card does not change under it): 0 or the CUDA error of the first try.
int bwd_setup(int* sms) {
  static int err = -1, count = 0;
  if (err < 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(&kplanes_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    err = static_cast<int>(e);
  }
  *sms = count;
  return err;
}

}  // namespace

// Forward: planes (host array of scales * 6 device pointers, (C, H, W) f32
// each, scale-major in itertools order), reso (host, scales x 4: x, y, z, t),
// xyz (n, 3), ts (f,) -> packed (the channels-last copy, kept for the
// backward) and out (f, n, C * scales), all f32 and contiguous.
extern "C" int kplanes_fwd(const long long* planes, const int* reso, int scales, int C,
                           const void* xyz, const void* ts, int n, int f, void* packed,
                           void* out, void* stream) {
  Geom g;
  int bad = make_geom(reso, scales, C, &g);
  if (bad) return bad;
  if (n < 0 || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  Sources src;
  for (int k = 0; k < g.nplanes; ++k) src.p[k] = reinterpret_cast<const float*>(planes[k]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kplanes_pack_kernel<<<blocks_for(g.off[g.nplanes]), THREADS, 0, st>>>(
      g, src, static_cast<float*>(packed));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0 || f == 0) return static_cast<int>(err);
  kplanes_fwd_kernel<<<dim3(blocks_for(static_cast<long long>(n) * g.Q), scales), THREADS, 0,
                       st>>>(g, static_cast<const float*>(packed),
                             static_cast<const float*>(xyz), static_cast<const float*>(ts), n, f,
                             static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Backward: the forward's packed copy, xyz, ts and the features' gradient
// gout (f, n, C * scales) -> grad, the planes' gradients in one flat buffer
// ((C, H, W) each at the packed copy's offsets); scratch is a buffer of the
// same size (the channels-last sums).
extern "C" int kplanes_bwd(const void* packed, const int* reso, int scales, int C,
                           const void* xyz, const void* ts, const void* gout, int n, int f,
                           void* scratch, void* grad, void* stream) {
  Geom g;
  int bad = make_geom(reso, scales, C, &g);
  if (bad) return bad;
  if (n < 0 || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = g.off[g.nplanes];
  cudaError_t err = cudaMemsetAsync(scratch, 0, total * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && f > 0) {
    const size_t smem = shared_bytes(g);
    if (smem > static_cast<size_t>(SMEM_MAX)) return static_cast<int>(cudaErrorInvalidValue);
    int sms = 0;
    bad = bwd_setup(&sms);
    if (bad) return bad;
    const int slices = scales * g.Q;
    const int fill = BLOCKS_PER_SM * sms / slices;
    const int target = fill > 1 ? fill : 1;
    long long per = (n + target - 1) / target;
    per = (per + THREADS - 1) / THREADS * THREADS;
    const dim3 grid(static_cast<unsigned int>((n + per - 1) / per), slices);
    kplanes_bwd_kernel<<<grid, THREADS, smem, st>>>(
        g, static_cast<const float*>(packed), static_cast<const float*>(xyz),
        static_cast<const float*>(ts), static_cast<const float*>(gout), n, f,
        static_cast<int>(per), static_cast<float*>(scratch));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kplanes_unpack_kernel<<<blocks_for(total), THREADS, 0, st>>>(
      g, static_cast<const float*>(scratch), static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kplanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
