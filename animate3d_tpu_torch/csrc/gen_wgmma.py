"""Write ``wgmma_ops.cuh``: the bf16 -> f32 ``wgmma.mma_async`` m64nNk16
instructions as inline PTX, one struct per N, for the Hopper kernels.

    python3 animate3d_tpu_torch/csrc/gen_wgmma.py

Each instruction names all N/2 accumulator registers of a thread, so the
operand lists are written out here rather than by hand.
"""

from pathlib import Path

WIDTHS = (16, 32, 48, 64, 80, 128, 160)

HEAD = """// Generated by gen_wgmma.py: do not edit by hand.
//
// Wgmma<N>::ss<TA, TB>(d, desc_a, desc_b, scale_d): d (64 x N, f32) (+)= A B
// with A (64 x 16) and B (16 x N) bf16 in shared memory, given by matrix
// descriptors; TA / TB = 1 reads that operand MN-major (transposed).
// Wgmma<N>::rs<TB>(d, a, desc_b, scale_d): the same with A in registers
// (the m16n8k16 A fragment of each warp's 16 rows). scale_d = 0 overwrites
// d. d is the warpgroup's accumulator fragment: thread (warp w, lane l)
// holds rows 16w + l/4 (+8) and columns 8i + 2(l%4) (+1) as d[4i .. 4i+3].

#pragma once

#include <stdint.h>

template <int N>
struct Wgmma;
"""


def struct(n: int) -> str:
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    ss = (f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"\n'
          f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
          f'      "{{{regs}}}, %{r}, %{r + 1}, p, 1, 1, %{r + 3}, %{r + 4};\\n}}\\n"\n'
          f'      : {outs}\n'
          f'      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));')
    rs = (f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
          f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
          f'      "{{{regs}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, '
          f'%{r + 6};\\n}}\\n"\n'
          f'      : {outs}\n'
          f'      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), '
          f'"n"(TB));')
    return f"""
template <>
struct Wgmma<{n}> {{
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[{r}], uint64_t da, uint64_t db,
                                            int scale_d) {{
    asm volatile(
{ss}
  }}
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[{r}], const unsigned (&a)[4],
                                            uint64_t db, int scale_d) {{
    asm volatile(
{rs}
  }}
}};
"""


if __name__ == "__main__":
    out = Path(__file__).with_name("wgmma_ops.cuh")
    out.write_text(HEAD + "".join(struct(n) for n in WIDTHS))
    print(f"wrote {out}")
