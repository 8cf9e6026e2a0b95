"""The (data, gauss) mesh over torch.distributed (port of
langsplat4d/parallel/mesh.py).

One process per rank, started by `python -m torch.distributed.run`
(torchrun) or by `torch.multiprocessing.spawn`. Rank r sits at (data
r // gauss, gauss r % gauss), the JAX mesh's row-major device order:
- "data" splits the camera batch (`shard_batch`);
- "gauss" splits the per-Gaussian rows: the parameters, their Adam moments
  and the densification buffers (`shard_state`); the deformation network,
  `aabb`, `num_active` and the Adam step are replicated.

Where the JAX package annotates shardings and lets XLA insert the
collectives, here they are written out: `RowGather` all-gathers rows over
"gauss" with a backward that keeps this rank's block, `gauss_sum` and
`data_mean` reduce the gradients of the replicated leaves, and
`unshard_state` gathers a whole state. Under gloo, a collective on CUDA
tensors goes through host copies, so that ranks that share one card (NCCL
refuses that) run the same code.

A capacity that `gauss` does not divide is rounded up: `shard_state` pads
the rows with inactive padding (zero moments), and `unshard_state` cuts
them off again, so the whole state keeps its capacity.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from langsplat4d_torch.core.state import (PAD_LOG_SCALE, PAD_OPACITY_LOGIT,
                                          GaussianState)
from langsplat4d_torch.train.optim import AdamState
from langsplat4d_torch.train.trainstate import GAUSSIAN_KEYS, TrainState

#: seconds a collective waits for its peers before it fails
GROUP_TIMEOUT = datetime.timedelta(seconds=600)

#: the per-row buffers of a TrainState, sharded like the parameters
ROW_BUFFERS = ("max_radii2d", "xyz_gradient_accum", "denom",
               "deformation_table", "deformation_accum")


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, gauss) mesh and its two groups. A group
    is None where the axis has one rank in a larger world, or where there is
    no process group: a collective over it does nothing. In a world of one
    rank both are the world's group, so that its collectives run through
    the backend."""
    data: int
    gauss: int
    rank: int = 0
    backend: Optional[str] = None
    data_group: Any = None
    gauss_group: Any = None

    @property
    def size(self) -> int:
        return self.data * self.gauss

    @property
    def data_rank(self) -> int:
        return self.rank // self.gauss

    @property
    def gauss_rank(self) -> int:
        return self.rank % self.gauss

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    # -- collectives (each a no-op over an axis of one rank) --------------

    def _for_backend(self, x: torch.Tensor) -> torch.Tensor:
        """What the backend takes: host copies under gloo, the current card's
        under NCCL, bool as uint8."""
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if self.backend == "gloo" and x.is_cuda:
            x = x.cpu()
        elif self.backend == "nccl" and not x.is_cuda:
            x = x.cuda()
        return x.contiguous()

    def all_gather(self, x: torch.Tensor, axis: str = "gauss"
                   ) -> torch.Tensor:
        """The blocks of every rank of `axis`, concatenated on dim 0 in
        rank order; every block must have x's shape."""
        group, n = self._group(axis)
        if group is None and n == 1:
            return x
        h = self._for_backend(x)
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        return torch.cat(parts).to(x.device, x.dtype)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM,
                   axis: str = "gauss") -> torch.Tensor:
        """A reduced copy of x over `axis`."""
        group, n = self._group(axis)
        if group is None and n == 1:
            return x
        h = self._for_backend(x)
        h = h.clone() if h is x else h
        dist.all_reduce(h, op=op, group=group)
        return h.to(x.device, x.dtype)

    def all_to_all(self, x: torch.Tensor, send: Sequence[int],
                   recv: Sequence[int], axis: str = "gauss") -> torch.Tensor:
        """Rows x[sum(send[:j]):sum(send[:j+1])] to rank j of `axis`; the
        received rows, sender by sender (recv[j] rows from rank j)."""
        group, n = self._group(axis)
        if group is None and n == 1:
            return x
        h = self._for_backend(x)
        out = h.new_empty((int(sum(recv)),) + tuple(h.shape[1:]))
        dist.all_to_all_single(out, h, [int(c) for c in recv],
                               [int(c) for c in send], group=group)
        return out.to(x.device, x.dtype)

    def _group(self, axis: str):
        if axis == "gauss":
            return self.gauss_group, self.gauss
        if axis == "data":
            return self.data_group, self.data
        if axis == "world":
            return (dist.group.WORLD if dist.is_initialized() else None,
                    self.size)
        raise ValueError(f"unknown mesh axis {axis!r}")


def _world_group_or_new(ranks: List[int], world: int):
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks, timeout=GROUP_TIMEOUT)


def init_from_env(backend: str) -> bool:
    """The default process group from the environment that torchrun sets
    (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT), where it names more than
    one rank and there is no group yet. Returns whether this call made
    one."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dist.init_process_group(backend, init_method="env://",
                            timeout=GROUP_TIMEOUT)
    return True


def make_mesh(data: int = 1, gauss: int = 1,
              backend: Optional[str] = None) -> Mesh:
    """This rank's mesh of `data` x `gauss` ranks over the default process
    group (made first by `init_from_env(backend)` where `backend` is given);
    a 1 x 1 mesh needs none. Raises where the world size is not
    data * gauss: the port does not fall back to fewer ranks."""
    if data < 1 or gauss < 1:
        raise ValueError(f"mesh shape (data={data}, gauss={gauss})")
    want = data * gauss
    if backend is not None:
        init_from_env(backend)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != want:
        raise ValueError(
            f"mesh shape (data={data}, gauss={gauss}) needs {want} ranks but "
            f"the world has {world}: start {want} processes (python -m "
            f"torch.distributed.run --nproc_per_node {want}); the port does "
            "not fall back to one device")
    if want == 1:
        if not dist.is_initialized():
            return Mesh(1, 1)
        return Mesh(1, 1, 0, dist.get_backend(), dist.group.WORLD,
                    dist.group.WORLD)
    rank = dist.get_rank()
    mesh = Mesh(data, gauss, rank, dist.get_backend())
    # every rank makes every group, in one order
    if gauss > 1:
        for d in range(data):
            g = _world_group_or_new([d * gauss + i for i in range(gauss)],
                                    world)
            if d == rank // gauss:
                mesh.gauss_group = g
    if data > 1:
        for i in range(gauss):
            g = _world_group_or_new([d * gauss + i for d in range(data)],
                                    world)
            if i == rank % gauss:
                mesh.data_group = g
    return mesh


# -- rows -----------------------------------------------------------------

def block_rows(capacity: int, gauss: int) -> int:
    """Rows per rank: the capacity rounded up to a multiple of `gauss`,
    divided by it."""
    return -(-capacity // gauss)


def _pad_fill(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    if n == 0:
        return x
    shape = (n,) + tuple(x.shape[1:])
    if isinstance(fill, torch.Tensor):
        rows = fill.to(x.device, x.dtype).expand(shape)
    else:
        rows = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, rows])


def shard_rows(x: torch.Tensor, mesh: Mesh, fill=0) -> torch.Tensor:
    """This rank's block of x's rows, the rows past the capacity being
    `fill` (a scalar, or one row)."""
    per = block_rows(x.shape[0], mesh.gauss)
    x = _pad_fill(x, per * mesh.gauss - x.shape[0], fill)
    r = mesh.gauss_rank
    return x[r * per:(r + 1) * per].clone()


#: the padding rows of a parameter (by its name in TrainState.params and
#: in GaussianState alike): those of core/state.py
PARAM_FILL = {"opacity": PAD_OPACITY_LOGIT, "scaling": PAD_LOG_SCALE,
              "rotation": torch.tensor([1.0, 0.0, 0.0, 0.0])}


def shard_gaussians(gs: GaussianState, mesh: Mesh) -> GaussianState:
    """This rank's block of a GaussianState's rows (a render's share)."""
    fields = {f.name: getattr(gs, f.name) for f in dataclasses.fields(gs)}
    out = {k: shard_rows(v, mesh, PARAM_FILL.get(k, 0))
           for k, v in fields.items() if torch.is_tensor(v)}
    return GaussianState(**out, num_active=gs.num_active,
                         row_offset=mesh.gauss_rank * block_rows(
                             gs.capacity, mesh.gauss))


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's share of a whole TrainState: its block of every
    GAUSSIAN_KEYS leaf, of their Adam moments and of the per-row buffers;
    the deformation network (the same module), its moments, aabb,
    num_active and the Adam step as they are."""
    if mesh.gauss == 1:
        return state
    if state.full_capacity is not None:
        raise ValueError("shard_state: the state is already sharded")
    fill = {"deformation_table": True}
    params = {k: shard_rows(v, mesh, PARAM_FILL.get(k, 0))
              if k in GAUSSIAN_KEYS else v for k, v in state.params.items()}
    m = {k: shard_rows(v, mesh) if k in GAUSSIAN_KEYS else v
         for k, v in state.opt.m.items()}
    v = {k: shard_rows(t, mesh) if k in GAUSSIAN_KEYS else t
         for k, t in state.opt.v.items()}
    return dataclasses.replace(
        state, params=params, opt=AdamState(m, v, state.opt.step),
        **{k: shard_rows(getattr(state, k), mesh, fill.get(k, 0))
           for k in ROW_BUFFERS},
        row_offset=mesh.gauss_rank * block_rows(state.capacity, mesh.gauss),
        full_capacity=state.capacity)


def unshard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The whole TrainState from every rank's share (a collective: every
    rank of the gauss axis calls it, and every one gets the whole state)."""
    if state.full_capacity is None:
        return state
    cap = state.full_capacity

    def whole(x):
        return mesh.all_gather(x)[:cap]
    params = {k: whole(v) if k in GAUSSIAN_KEYS else v
              for k, v in state.params.items()}
    m = {k: whole(v) if k in GAUSSIAN_KEYS else v
         for k, v in state.opt.m.items()}
    v = {k: whole(t) if k in GAUSSIAN_KEYS else t
         for k, t in state.opt.v.items()}
    return dataclasses.replace(
        state, params=params, opt=AdamState(m, v, state.opt.step),
        **{k: whole(getattr(state, k)) for k in ROW_BUFFERS},
        row_offset=0, full_capacity=None)


def apply_unsharded(state: TrainState, mesh: Optional[Mesh],
                    fn: Callable[[TrainState], Any]):
    """fn on the whole state, the same on every rank, then this rank's
    share of what it returns (a TrainState, or a tuple whose first item is
    one). How densify, prune, reset_opacity and grow run under a mesh, as
    the JAX package's row-sharding constraint keeps them: every rank holds
    the whole state while fn runs."""
    if mesh is None or state.full_capacity is None:
        return fn(state)
    out = fn(unshard_state(state, mesh))
    if isinstance(out, tuple):
        return (shard_state(out[0], mesh),) + tuple(out[1:])
    return shard_state(out, mesh)


def shard_batch(batch, mesh: Mesh):
    """This data rank's slice of a camera batch: a sequence of cameras, or
    a step.Batch (every leaf leads with the camera axis). The batch size
    must be a multiple of the data axis."""
    if mesh.data == 1:
        return batch
    n = (len(batch) if isinstance(batch, (list, tuple))
         and not hasattr(batch, "_fields") else batch.times.shape[0])
    if n % mesh.data:
        raise ValueError(f"batch of {n} cameras over data={mesh.data}")
    per = n // mesh.data
    sl = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    if not hasattr(batch, "_fields"):
        return list(batch)[sl]

    def cut(x):
        if x is None:
            return None
        if hasattr(x, "_fields"):
            return type(x)(*[cut(t) for t in x])
        return x[sl]
    return type(batch)(*[cut(t) for t in batch])


class RowGather(torch.autograd.Function):
    """All-gather of rows over the gauss axis whose backward returns this
    rank's block of the incoming gradient. Every gauss rank computes the
    same loss on the gathered rows, so each holds the whole gradient of
    them: the block is the gradient of its own rows. A reduce-scatter (the
    sum that torch.distributed.nn's all_gather returns) would count it
    `gauss` times."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.n, ctx.r = x.shape[0], mesh.gauss_rank
        return mesh.all_gather(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g[ctx.r * ctx.n:(ctx.r + 1) * ctx.n], None


def gather_columns(cols: Dict[str, torch.Tensor], mesh: Mesh
                   ) -> Dict[str, torch.Tensor]:
    """Every rank's rows of a dict of [n, ...] float tensors in one
    collective (`RowGather`, differentiable): the columns side by side,
    gathered, and cut apart again. Bool tensors come back bool."""
    if mesh.gauss_group is None:
        return cols
    names = list(cols)
    flat = [cols[k].reshape(cols[k].shape[0], -1) for k in names]
    widths = [f.shape[1] for f in flat]
    table = torch.cat([f.float() for f in flat], dim=1)
    whole = RowGather.apply(table, mesh)
    out = {}
    for k, part in zip(names, torch.split(whole, widths, dim=1)):
        t = part.reshape((whole.shape[0],) + tuple(cols[k].shape[1:]))
        out[k] = t > 0.5 if cols[k].dtype == torch.bool else t
    return out


def _reduce_many(ts: List[torch.Tensor], mesh: Mesh, axis: str
                 ) -> List[torch.Tensor]:
    """A SUM all-reduce of several tensors over `axis` in one collective."""
    if not ts or mesh._group(axis) == (None, 1):
        return ts
    flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in ts]),
                           axis=axis)
    return [p.reshape(t.shape) for p, t in
            zip(torch.split(flat, [t.numel() for t in ts]), ts)]


def gauss_sum(ts: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Sums over the gauss axis: the gradient of a replicated leaf, each
    gauss rank's holding the part that its own rows reach."""
    return _reduce_many(ts, mesh, "gauss")


def data_mean(ts: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Means over the data axis: a loss that is a mean over the camera
    batch has the mean of the data ranks' gradients as its own."""
    return [t / mesh.data for t in _reduce_many(ts, mesh, "data")]
