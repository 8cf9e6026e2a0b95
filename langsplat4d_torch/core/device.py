"""Where the port's entry points put their tensors."""
from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device=None) -> torch.device:
    """`device=None` means the current CUDA device, and raises where there
    is none: the port runs on the GPU unless the caller asks for the CPU by
    name. Under a torch.distributed process group it means the card of the
    rank's LOCAL_RANK (modulo the cards there are; ranks may share a card
    under gloo only: NCCL refuses that itself). Anything else goes to
    `torch.device`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: langsplat4d_torch runs on the GPU unless "
                "the caller passes device='cpu'")
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            return torch.device("cuda", local % torch.cuda.device_count())
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@contextlib.contextmanager
def fp32_matmul():
    """Matrix products in full fp32 for the duration: TF32 off for matmuls
    and cuDNN (the package turns it off at import; this holds it off against
    a caller that turned it back on), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
