from repro_torch.serving.engine import ServingEngine  # noqa: F401
