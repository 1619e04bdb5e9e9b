from repro_torch.kernels.swa_attention.ops import swa_attention  # noqa: F401
