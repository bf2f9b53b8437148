"""Published figures of one NVIDIA H100 SXM card (NVIDIA's data sheet,
dense rates at the full 700 W power limit), and the links between cards.
The roofline (``analysis.py``) and ``chip_smoke.py``'s kernel bounds read
them from here, and from nowhere else."""

HBM_BYTES_PER_S = 3.35e12          # HBM3
HBM_BYTES = 80e9                   # HBM3 capacity
L2_BYTES = 50 * 2 ** 20
BF16_FLOPS_PER_S = 989e12          # dense bf16 on the tensor cores
FP32_FLOPS_PER_S = 67e12           # float32 on the CUDA cores
# one card's bandwidth each way: NVLink 4 inside an 8-card node, one
# 400 Gb/s NIC per card between nodes
NVLINK_BYTES_PER_S = 450e9
NIC_BYTES_PER_S = 50e9
CARDS_PER_NODE = 8
