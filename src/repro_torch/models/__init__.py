from repro_torch.models.model import (  # noqa: F401
    decode_step_fn,
    init_decode_state,
    init_params,
    loss_fn,
    model_forward,
    prefill_fn,
)
