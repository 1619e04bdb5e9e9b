"""Optimizer (port of ``repro.optim``): AdamW, the learning-rate schedule
and the ZeRO partial-sharding placement rule."""
from repro_torch.optim.adamw import (adamw_init, adamw_update,  # noqa: F401
                                     adamw_update_)
from repro_torch.optim.schedule import lr_schedule  # noqa: F401
from repro_torch.optim.zero import validate_partial_sharding  # noqa: F401
