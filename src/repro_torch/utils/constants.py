"""Target-hardware constants: NVIDIA H100 SXM, from NVIDIA's data sheet,
and the paper's model of a migration's transfer.

The card's are published peaks, not measurements.  A card run below its 700 W
power limit reaches less.  Measured numbers live in ``PERF.md``, each beside
the card's name and power limit.
"""

DATASHEET_HBM_BYTES = 80e9            # 80 GB HBM3
DATASHEET_HBM_BANDWIDTH = 3.35e12     # 3.35 TB/s
DATASHEET_PEAK_BF16_FLOPS = 989e12    # dense bf16 tensor-core rate
DATASHEET_PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
# 32-bit integer multiply-add, the slowest integer instruction: 64 per clock
# per SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0) x 132 SMs x the 1.98 GHz boost clock
DATASHEET_INT32_OPS = 64 * 132 * 1.98e9

# Links, for the dry-run's collective term (``analysis/roofline.py``):
# NVLink 4 gives an H100 SXM 900 GB/s in both directions, 450 GB/s each
# way, to the others of its 8-GPU node (NVIDIA H100 data sheet); across
# nodes each GPU has one InfiniBand NDR port, 400 Gb/s = 50 GB/s each way
# (NVIDIA ConnectX-7 / DGX H100 data sheets).  Published rates, not
# measurements.
DATASHEET_NVLINK_BANDWIDTH = 450e9
DATASHEET_IB_NDR_BANDWIDTH = 50e9

# The paper's migration transfer model (Table 5), not a measurement of
# this card or of any store: checkpoints go to and come from a remote blob
# store at this rate; the same values as the JAX package's.
BLOB_STORE_BANDWIDTH = 2e9      # 2 GB/s effective to remote storage
HOST_DEVICE_BANDWIDTH = 32e9    # host<->device staging
