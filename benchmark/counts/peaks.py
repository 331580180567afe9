"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its
700 W power limit."""

PEAK_BF16_FLOPS = 989e12  # tensor cores, bf16 / fp16
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
PEAK_EX2 = 3.9e12  # SFU: 16 ex2 a clock an SM x 132 SMs x 1.83 GHz
