"""Where the port's entry points put their tensors."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device=None` means the current CUDA device, and raises where there
    is none: the port runs on the GPU unless the caller asks for the CPU by
    name. Anything else goes to `torch.device`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: langsplat4d_torch runs on the GPU unless "
                "the caller passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
