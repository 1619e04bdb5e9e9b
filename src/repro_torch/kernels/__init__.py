"""Hand-written Hopper kernels of the port.

- ``swa_attention`` — causal, optionally sliding-window flash attention
  forward, in CUDA C++ (``csrc/swa_flash.cu``), in place of the Pallas TPU
  kernel ``repro.kernels.swa_attention.swa.swa_flash``.
- ``ssd_scan`` — the Mamba2 SSD chunked scan; its intra-chunk step is in
  CUDA C++ (``csrc/ssd_intra_chunk.cu``), in place of the Pallas TPU kernel
  ``repro.kernels.ssd_scan.ssd.ssd_intra_chunk``.

Each kernel directory has the CUDA source under ``csrc/``, its ctypes
binding, ``ops.py`` (the public wrapper, same signature as the JAX one) and
``ref.py`` (the plain PyTorch version that CPU tensors take and that the
tests and ``chip_smoke.py`` hold the kernel against).  ``_build.py``
compiles the sources at first use.  The Pallas kernels ``fused_ce_stats``
and ``fingerprint_u32`` are not ported yet (ROADMAP.md).
"""
