"""Target-hardware constants: NVIDIA H100 SXM, from NVIDIA's data sheet.

These are published peaks, not measurements.  A card run below its 700 W
power limit reaches less.  Measured numbers live in ``PERF.md``, each beside
the card's name and power limit.
"""

DATASHEET_HBM_BYTES = 80e9            # 80 GB HBM3
DATASHEET_HBM_BANDWIDTH = 3.35e12     # 3.35 TB/s
DATASHEET_PEAK_BF16_FLOPS = 989e12    # dense bf16 tensor-core rate
DATASHEET_PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
