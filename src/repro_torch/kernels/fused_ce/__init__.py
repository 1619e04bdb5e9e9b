from repro_torch.kernels.fused_ce.ops import fused_cross_entropy  # noqa: F401
