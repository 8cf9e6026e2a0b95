"""Render CLI, `python -m langsplat4d_torch.render` (port of the root
render.py; reference render.py:181-210).

Renders the train, video and test splits of a trained model in rgb or lang
mode at a chosen stage and iteration, writes PNG renders, raw .npy maps (the
eval's input) and mp4 videos where an mp4 writer is installed, and prints
the FPS line. The model's `cfg_args` are read back under the command line's
configuration, with the command line's source and model paths applied
again. `--load_stage fine-lang-discrete` renders through each Gaussian's
mixed language prototypes. Runs on the GPU unless `--device cpu`; without a
GPU it raises.

Under torchrun (`python -m torch.distributed.run --nproc_per_node D -m
langsplat4d_torch.render ... --dist_backend nccl|gloo`) each rank joins the
process group from the environment and takes the card of its LOCAL_RANK;
a config with `runtime.gaussian_shards` = D renders by tile-row bands
(render/driver.py) and rank 0 writes. `--dist_backend` is nccl by default,
gloo with `--device cpu`; ranks that share one card need gloo. One process
with `gaussian_shards` 1 is the single-device path, with no group.
"""
import argparse
import sys

import torch

from langsplat4d_torch.checkpoint import load_trained_model
from langsplat4d_torch.config import load_cfg_args, parse_cli
from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.data.scene import Scene
from langsplat4d_torch.field.deformation import DeformConfig
from langsplat4d_torch.parallel.mesh import init_from_env
from langsplat4d_torch.render.driver import render_set
from langsplat4d_torch.utils.logging import get_logger


def parse_args(argv=None):
    """The command line -> (the CLI's own flags, the rest, which the
    config parser reads and where an unknown flag is ignored)."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--skip_video", action="store_true")
    parser.add_argument("--mode", choices=["rgb", "lang"], default="rgb")
    parser.add_argument("--novideo", type=int, default=0)
    parser.add_argument("--noimage", type=int, default=0)
    parser.add_argument("--nonpy", type=int, default=0)
    parser.add_argument("--load_stage", type=str, default="fine-lang")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the current CUDA device by "
                             "default (under torchrun, LOCAL_RANK's)")
    parser.add_argument("--dist_backend", type=str, default=None,
                        help="torch.distributed backend under torchrun: "
                             "nccl by default, gloo with --device cpu")
    return parser.parse_known_args(argv)


def main(argv=None):
    """Returns {split: FPS} of the splits rendered."""
    args, rest = parse_args(argv)
    made = init_from_env(dist_backend(args))
    try:
        return _render(args, rest)
    finally:
        if made:
            torch.distributed.destroy_process_group()


def dist_backend(args) -> str:
    """--dist_backend, or nccl for the card and gloo for --device cpu."""
    if args.dist_backend:
        return args.dist_backend
    return "gloo" if args.device == "cpu" else "nccl"


def _render(args, rest):
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)

    cfg = parse_cli(rest, description="Testing script parameters")
    if cfg.model.model_path:
        cfg = load_cfg_args(cfg.model.model_path, cfg)
        # the command line's paths over the persisted cfg_args
        cli = parse_cli(rest)
        if cli.model.source_path:
            cfg.model.source_path = cli.model.source_path
        cfg.model.model_path = cli.model.model_path or cfg.model.model_path
    logger = get_logger()
    logger.info("Rendering %s", cfg.model.model_path)

    scene = Scene(cfg.model.source_path, images=cfg.model.images,
                  eval_split=cfg.model.eval, llffhold=cfg.model.llffhold,
                  white_background=cfg.model.white_background,
                  extension=cfg.model.extension,
                  model_path=cfg.model.model_path)
    dcfg = DeformConfig.from_config(cfg.hidden, cfg.runtime,
                                    max_sh_degree=cfg.model.sh_degree)
    model, loaded_iter = load_trained_model(
        cfg.model.model_path, args.load_stage, args.iteration, dcfg,
        max_sh_degree=cfg.model.sh_degree, aabb=scene.aabb, device=device)
    kw = dict(noimage=bool(args.noimage), nonpy=bool(args.nonpy),
              novideo=bool(args.novideo), load_stage=args.load_stage,
              mode=args.mode)
    fps = {}
    for split, skip, views in (
            ("train", args.skip_train, scene.getTrainCameras),
            ("video", args.skip_video, scene.getVideoCameras),
            ("test", args.skip_test, scene.getTestCameras)):
        if not skip:
            fps[split] = render_set(cfg, model, dcfg, scene, split,
                                    loaded_iter, views(), **kw)
    return fps


if __name__ == "__main__":
    main(sys.argv[1:])
