"""Hand-written Hopper kernels of the port.

- ``swa_attention`` — causal, optionally sliding-window flash attention
  forward, in CUDA C++ (``csrc/swa_flash.cu``), in place of the Pallas TPU
  kernel ``repro.kernels.swa_attention.swa.swa_flash``, and its backward
  (``csrc/swa_flash_bwd.cu``), which replaces no TPU kernel: JAX
  differentiates its jnp attention through XLA.
- ``ssd_scan`` — the Mamba2 SSD chunked scan; its intra-chunk step is in
  CUDA C++ (``csrc/ssd_intra_chunk.cu``), in place of the Pallas TPU kernel
  ``repro.kernels.ssd_scan.ssd.ssd_intra_chunk``.
- ``fused_ce`` — streaming-vocab cross-entropy statistics (lse, label
  logit) in CUDA C++ (``csrc/fused_ce_stats.cu``), in place of the Pallas
  TPU kernel ``repro.kernels.fused_ce.ce.fused_ce_stats``, and their
  backward (``csrc/fused_ce_bwd.cu``: the logits recomputed and turned into
  the gradient's coefficients, whose two products run on the tensor
  cores), which replaces no TPU kernel: JAX differentiates
  ``chunked_cross_entropy`` through XLA.  The two share the logits tile of
  ``include/ce_logits.cuh``.
- ``checksum`` — the 128-bit content fingerprint of a buffer (four uint32
  lanes of position-weighted sums) in CUDA C++
  (``csrc/fingerprint_u32.cu``), in place of the Pallas TPU kernel
  ``repro.kernels.checksum.fingerprint.fingerprint_u32``.

Each kernel directory has the CUDA source under ``csrc/``, its ctypes
binding, ``ops.py`` (the public wrapper, same signature as the JAX one) and
``ref.py`` (the plain PyTorch version that CPU tensors take and that the
tests and ``chip_smoke.py`` hold the kernel against).  ``_build.py``
compiles the sources at first use.  ``swa_attention`` and ``fused_ce``
are autograd functions; their bf16 backwards are the kernels
``swa_flash_bwd`` and ``fused_ce_bwd`` (the Pallas kernels have none).
Every Pallas kernel of the JAX package has its counterpart here.
"""
