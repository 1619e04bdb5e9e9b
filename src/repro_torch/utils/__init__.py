"""Utility package: hardware constants and device selection."""
import torch

from repro_torch.utils import constants  # noqa: F401

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    Entry points default to ``"cuda"`` and raise when no card is there; the
    CPU runs only when the caller names it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string (``ModelConfig.dtype``) as a torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]
