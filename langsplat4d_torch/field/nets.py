"""MLP building blocks (port of langsplat4d/field/nets.py).

Layouts follow the reference's nn.Sequential stacks so `deformation.pth`
state-dict keys line up: a trunk is Linear, ReLU, Linear, ... (Linears at
even indices) and a head is ReLU, Linear, ReLU, Linear, ... (odd indices).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def init_linear_(layer: nn.Linear, generator: torch.Generator) -> nn.Linear:
    """Xavier-uniform weight (reference scene/deformation.py:254-259) and the
    torch-Linear default uniform bias, drawn from `generator`."""
    fan_out, fan_in = layer.weight.shape
    bound_w = math.sqrt(6.0 / (fan_in + fan_out))
    bound_b = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound_w, bound_w, generator=generator)
        layer.bias.uniform_(-bound_b, bound_b, generator=generator)
    return layer


def mlp(dims: Sequence[int], *, pre_relu: bool,
        generator: torch.Generator) -> nn.Sequential:
    """Linear layers of the given [in, h1, ..., out] dims with ReLU between
    them; `pre_relu` also puts a ReLU before the first Linear (the head
    pattern)."""
    layers = []
    for i in range(len(dims) - 1):
        if pre_relu or i > 0:
            layers.append(nn.ReLU())
        layers.append(init_linear_(nn.Linear(dims[i], dims[i + 1]),
                                   generator))
    return nn.Sequential(*layers)


def poc_freqs(n: int, device=None) -> torch.Tensor:
    return torch.tensor([2.0 ** i for i in range(n)], dtype=torch.float32,
                        device=device)


def poc_fre(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """[x, sin(x*2^i), cos(x*2^i)] with the reference's flattening
    (scene/deformation.py:261-267): x [..., d] -> [..., d*(1+2P)]."""
    emb = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(emb), torch.cos(emb)], dim=-1)
