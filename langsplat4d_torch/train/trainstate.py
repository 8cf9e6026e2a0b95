"""TrainState: everything a training step reads and updates (port of
langsplat4d/train/trainstate.py; the mutable GaussianModel attributes and
optimizer of the reference, scene/gaussian_model.py:49-69, 220-313).

The Gaussian tensors live in `params` by name, the deformation network is an
`nn.Module`, and `leaves()` gives both as one flat dict of named tensors (the
network's parameters as "deform.<state-dict key>") for the optimizer. The
training step updates the state in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from langsplat4d_torch.core.state import GaussianState
from langsplat4d_torch.field.deformation import DeformNetwork
from langsplat4d_torch.train.optim import AdamState, adam_init

GAUSSIAN_KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
                 "language_feature")
PARAM_TO_STATE = {
    "xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
    "opacity": "opacity", "scaling": "scaling", "rotation": "rotation",
    "language_feature": "language_feature",
}


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]     # the Gaussian tensors, GAUSSIAN_KEYS
    deform: DeformNetwork
    opt: AdamState                      # moments keyed as leaves()
    num_active: int
    max_radii2d: torch.Tensor           # [cap]
    xyz_gradient_accum: torch.Tensor    # [cap, 1]
    denom: torch.Tensor                 # [cap, 1]
    deformation_table: torch.Tensor     # [cap] bool
    deformation_accum: torch.Tensor     # [cap, 3]
    aabb: torch.Tensor                  # [2, 3]
    active_sh_degree: int = 0
    # a rank's block of the rows (parallel/mesh.py shard_state): its first
    # row in the whole state, and the whole state's capacity (None: whole)
    row_offset: int = 0
    full_capacity: Optional[int] = None

    @property
    def capacity(self) -> int:
        return self.params["xyz"].shape[0]

    @property
    def device(self) -> torch.device:
        return self.params["xyz"].device

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every trainable tensor by name, Gaussian tensors first."""
        out = dict(self.params)
        for name, p in self.deform.named_parameters():
            out["deform." + name] = p
        return out

    def gaussians(self) -> GaussianState:
        return GaussianState(
            **{PARAM_TO_STATE[k]: self.params[k] for k in GAUSSIAN_KEYS},
            num_active=self.num_active, row_offset=self.row_offset)


def make_train_state(gs: GaussianState, deform: DeformNetwork, aabb,
                     active_sh_degree: int = 0) -> TrainState:
    """A fresh state on the Gaussians' device: zero Adam moments and
    densification buffers. The tensors of `gs` and the network are taken as
    they are, not copied."""
    cap, dev = gs.capacity, gs.device
    state = TrainState(
        params={k: getattr(gs, PARAM_TO_STATE[k]) for k in GAUSSIAN_KEYS},
        deform=deform, opt=AdamState({}, {}), num_active=int(gs.num_active),
        max_radii2d=torch.zeros(cap, device=dev),
        xyz_gradient_accum=torch.zeros((cap, 1), device=dev),
        denom=torch.zeros((cap, 1), device=dev),
        deformation_table=torch.ones(cap, dtype=torch.bool, device=dev),
        deformation_accum=torch.zeros((cap, 3), device=dev),
        aabb=torch.as_tensor(aabb, dtype=torch.float32, device=dev),
        active_sh_degree=active_sh_degree)
    state.opt = adam_init(state.leaves())
    return state


def reset_densification_stats(state: TrainState) -> TrainState:
    for buf in (state.xyz_gradient_accum, state.denom, state.max_radii2d,
                state.deformation_accum):
        buf.zero_()
    return state


def one_up_sh_degree(state: TrainState, max_sh_degree: int) -> TrainState:
    """oneupSHdegree (gaussian_model.py:188-190)."""
    if state.active_sh_degree < max_sh_degree:
        state.active_sh_degree += 1
    return state
