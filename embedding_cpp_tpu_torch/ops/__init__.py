"""Device ops: quantized weights, the fused dequant-matmul and projection-
layout attention kernels (CUDA sources in `csrc/`), and `linear`."""
