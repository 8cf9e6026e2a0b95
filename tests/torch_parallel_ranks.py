"""The ranks of the port's multi-rank tests (tests/test_torch_parallel_*.py).

`spawn` starts `world` processes with torch.multiprocessing.spawn; each
joins a gloo process group through a file:// store in the test's tmp_path
(so that parallel test workers never race for a port), runs one of the rank
functions below on the CPU with one thread, and writes what it got with
torch.save for the test to compare. The group and the join have timeouts,
so that a hang fails the test in under a minute. Nothing here imports JAX,
and each rank refuses it.
"""
import copy
import datetime
import os
import sys
import time
import uuid

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a collective waits, and seconds the whole spawn may take
GROUP_TIMEOUT = 45
JOIN_TIMEOUT = 55


def spawn(fn, world, tmp_path, *args):
    """fn(rank, world, *args) on `world` gloo ranks; raises where a rank
    raised, or where the ranks outlast JOIN_TIMEOUT."""
    store = os.path.join(str(tmp_path), f"store_{uuid.uuid4().hex}")
    ctx = mp.start_processes(_entry, args=(fn, world, store, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} on {world} ranks outlasted "
                               f"{JOIN_TIMEOUT} s")


class _RefuseJax:
    """An import hook that refuses JAX, the JAX package and TensorFlow, as
    the GPU machine has none of them (tensorboard reaches for TensorFlow,
    and TensorFlow for JAX, where they are installed; both go on without
    them, and the port's telemetry without tensorboard)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "langsplat4d",
                                  "tensorflow"):
            raise ImportError("refused: " + name)


def _entry(rank, fn, world, store, args):
    sys.meta_path.insert(0, _RefuseJax())
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def _load(path):
    return torch.load(path, weights_only=False)


def band_render(rank, world, inp, out):
    """render_tiles_sharded and render_tiles_scatter on this rank's rows;
    rank 0 saves the stitched images, and every rank its band and
    `dropped`."""
    from langsplat4d_torch.parallel.mesh import make_mesh, shard_rows
    from langsplat4d_torch.parallel.render import (gather_bands,
                                                   render_tiles_scatter,
                                                   render_tiles_sharded)
    d = _load(inp)
    mesh = make_mesh(1, world)
    rows = [shard_rows(d[k], mesh) for k in
            ("means", "opac", "scales", "quats", "colors", "lang")]
    active = shard_rows(d["active"], mesh, False)
    st, cam, bg = d["settings"], d["cam"], d["bg"]
    a = render_tiles_sharded(st, cam, *rows[:5], rows[5], active, bg, mesh)
    b, dropped = render_tiles_scatter(st, cam, *rows[:5], rows[5], active,
                                      bg, mesh)
    res = dict(allgather=gather_bands(a, st, mesh),
               alltoall=gather_bands(b, st, mesh), dropped=dropped,
               bands=(a, b))
    torch.save(res, f"{out}.{rank}")


def frame_banded(rank, world, inp, out):
    """render_frame_banded on this rank's block of a GaussianState, both
    exchanges; every rank saves its stitched frames."""
    from langsplat4d_torch.parallel.mesh import make_mesh, shard_gaussians
    from langsplat4d_torch.parallel.render import (gather_bands,
                                                   render_frame_banded)
    d = _load(inp)
    mesh = make_mesh(1, world)
    gs = shard_gaussians(d["gs"], mesh)
    res = {}
    with torch.no_grad():
        for ex in ("allgather", "alltoall"):
            o = render_frame_banded(
                d["settings"], d["dcfg"], d["stage"], d["cam"], d["time"],
                gs, d["net"], d["aabb"], d["bg"], mesh, exchange=ex)
            res[ex] = {k: gather_bands(o[k], d["settings"], mesh)
                       for k in ("render", "language_feature_image",
                                 "depth")}
            res[ex]["dropped"] = o["dropped"]
    torch.save(res, f"{out}.{rank}")


def train_steps(rank, world, inp, out):
    """Each case's train_step (a dict of the whole state, the StepConfig,
    the batch) on the data x gauss mesh of `inp`; saves the whole state
    after it (the leaves and the moments), this rank's blocks, and the
    metrics."""
    from langsplat4d_torch.parallel.mesh import (make_mesh, shard_batch,
                                                 shard_state, unshard_state)
    from langsplat4d_torch.train.step import train_step
    d = _load(inp)
    mesh = make_mesh(d["data"], d["gauss"])
    res = []
    for case in d["cases"]:
        state = shard_state(copy.deepcopy(case["state"]), mesh)
        b = case["batch"].times.shape[0]
        batch = shard_batch(case["batch"], mesh) if b % mesh.data == 0 \
            else case["batch"]
        state, metrics, vs_grad, vis, radii = train_step(
            case["cfg"]._replace(mesh=mesh), state, batch, d["bg"], 1,
            d["sh_degree"])
        whole = unshard_state(state, mesh)
        res.append(dict(
            params={k: v.detach() for k, v in whole.leaves().items()},
            m=dict(whole.opt.m), v=dict(whole.opt.v), step=whole.opt.step,
            blocks={k: v.detach() for k, v in state.params.items()},
            m_blocks={k: state.opt.m[k] for k in state.params},
            row_offset=state.row_offset,
            metrics={k: float(v) for k, v in metrics.items()},
            vs_grad=vs_grad, radii=radii, visibility=vis))
    torch.save(res, f"{out}.{rank}")


def densify_ops(rank, world, inp, out):
    """densify, prune and reset_opacity under a data x gauss mesh
    (`apply_unsharded`) from the whole state in `inp`; saves the whole
    state after them."""
    from langsplat4d_torch.parallel.mesh import (apply_unsharded, make_mesh,
                                                 shard_state, unshard_state)
    from langsplat4d_torch.train import densify as D
    d = _load(inp)
    mesh = make_mesh(d["data"], d["gauss"])
    state = shard_state(d["state"], mesh)
    gen = torch.Generator().manual_seed(3)
    state = apply_unsharded(state, mesh, lambda s: D.densify(
        s, 1e-4, 1.6, 0.01, gen))
    state = apply_unsharded(state, mesh,
                            lambda s: D.prune(s, 0.3, 1.6, 20.0))
    state = apply_unsharded(state, mesh, D.reset_opacity)
    whole = unshard_state(state, mesh)
    torch.save(dict(params=dict(whole.params), m=dict(whole.opt.m),
                    num_active=whole.num_active,
                    max_radii2d=whole.max_radii2d,
                    local_rows=state.params["xyz"].shape[0]),
               f"{out}.{rank}")


def render_cli(rank, world, argv, out):
    """The render CLI's main on this rank (the group exists already, as
    torchrun's would)."""
    from langsplat4d_torch.render.__main__ import main
    torch.save(main(list(argv)), f"{out}.{rank}")


def mesh_faults(rank, world, out):
    """The messages of make_mesh with a shape of another size than the
    world."""
    from langsplat4d_torch.parallel.mesh import make_mesh
    msgs = []
    for data, gauss in ((1, world + 1), (world, 2)):
        try:
            make_mesh(data, gauss)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    torch.save(msgs, f"{out}.{rank}")


def train_loop(rank, world, cfg_path, out):
    """training(cfg) on the mesh that the config names; saves the whole
    state it returns."""
    from langsplat4d_torch.parallel.mesh import make_mesh, unshard_state
    from langsplat4d_torch.train.loop import training
    cfg = _load(cfg_path)
    state = training(cfg, device="cpu")
    whole = unshard_state(state, make_mesh(cfg.runtime.data_parallel,
                                           cfg.runtime.gaussian_shards))
    torch.save(dict(params={k: v.detach()
                            for k, v in whole.leaves().items()},
                    num_active=whole.num_active,
                    local_rows=state.params["xyz"].shape[0]),
               f"{out}.{rank}")
