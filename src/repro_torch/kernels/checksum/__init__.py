from repro_torch.kernels.checksum.ops import fingerprint  # noqa: F401
