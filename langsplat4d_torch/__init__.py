"""langsplat4d_torch — the PyTorch/CUDA port of langsplat4d for NVIDIA Hopper.

The JAX package `langsplat4d` is the reference; this package keeps its module
names so each counterpart is easy to find. Plain tensor code is PyTorch, and
each Pallas TPU kernel becomes a hand-written Hopper kernel under `csrc/`,
built with nvcc at first use and bound with ctypes. Everything here imports
torch and never jax.

fp32 throughout: TF32 is switched off for matmuls and cuDNN once, here, so
the port computes what the reference computes on every device.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
