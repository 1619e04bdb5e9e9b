"""Training (port of ``repro.training``): the train state and the spliced
train step."""
from repro_torch.training.state import TrainState, init_train_state  # noqa: F401
from repro_torch.training.step import build_train_step, loss_and_grads  # noqa: F401
