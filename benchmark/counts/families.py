"""Kernel-name families of the profiler's device events (the program's
kernel names and the libraries' naming), for shares of busy time."""

FAMILIES = (
    ("composite_coarse_fwd_kernel", "kernel H fwd"),
    ("composite_coarse_bwd_kernel", "kernel H bwd"),
    ("composite_fields_fwd_kernel", "kernel G fwd"),
    ("composite_fields_bwd_kernel", "kernel G bwd"),
    ("topk", "top-k binning"), ("sort", "top-k binning"),
    ("gesvd", "SVD (ARAP)"), ("svd", "SVD (ARAP)"),
    ("scatter", "gather / scatter"), ("gather", "gather / scatter"),
    ("index", "gather / scatter"),
    ("flash_fwd_kernel", "kernel A flash_fwd"),
    ("packed_attn_bwd_kernel", "kernel E packed_attn_bwd"),
    ("packed_attn_kernel", "kernel B packed_attn"),
    ("geglu_gemm_kernel", "kernel C geglu"),
    ("flash_bwd_delta_kernel", "kernel D flash_bwd Delta"),
    ("flash_bwd_kernel", "kernel D flash_bwd pass"),
    ("cast_scaled_kernel", "kernel D flash_bwd cast"),
    ("cast_heads_kernel", "kernel D flash_bwd cast"),
    ("softmax", "plain attention softmax"),
    ("conv", "convolution (cuDNN)"), ("xmma_fprop", "convolution (cuDNN)"),
    ("implicit", "convolution (cuDNN)"),
    ("norm", "group/layer norm"),
    ("gemm", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"), ("gemv", "matmul (cuBLAS)"),
)


def family(name: str) -> str:
    n = name.lower()
    for key, fam in FAMILIES:
        if key in n:
            return fam
    return "elementwise / copy / other"
