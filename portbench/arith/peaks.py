"""Published peaks of one NVIDIA H100 SXM5 (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12        # dense bf16 / fp16 tensor-core FLOP/s
TF32_FLOPS = 495e12        # dense TF32 tensor-core FLOP/s
FP32_FLOPS = 67e12         # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth
