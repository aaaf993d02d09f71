"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit). The card's own name and power limit are
printed beside every run's numbers."""

BF16_FLOPS = 989e12          # bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12    # device memory bandwidth
DEVICE_BYTES = 80e9          # device memory
