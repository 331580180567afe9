"""Kernel D (``csrc/flash_bwd.cu``: Delta, the pass and its casts): its
launches' least time over its device time. A launch counts under
``flash_bwd_dq`` where it writes dq and under ``flash_bwd_dkv`` where it
writes dk / dv; launches of one shape that write both are the lesser
count, the rest write one."""

from benchmark.counts import kernels

NAMES = ("flash_bwd_kernel", "flash_bwd_delta_kernel", "cast_scaled_kernel",
         "cast_heads_kernel")


def read(t):
    heads = int(t.counts.get("heads", 0))
    dq = {k: n for (c, k), n in t.launches.items() if c == "flash_bwd_dq"}
    dkv = {k: n for (c, k), n in t.launches.items() if c == "flash_bwd_dkv"}
    least = 0.0
    for key in set(dq) | set(dkv):
        a, b = dq.get(key, 0), dkv.get(key, 0)
        both = min(a, b)
        least += (both * kernels.flash_bwd(key, heads)
                  + (a - both) * kernels.flash_bwd(key, heads, dkv=False)
                  + (b - both) * kernels.flash_bwd(key, heads, dq=False))
    spent = t.kernel_seconds(*NAMES)
    if not heads or least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
