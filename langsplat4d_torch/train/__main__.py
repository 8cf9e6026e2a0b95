"""Training CLI, `python -m langsplat4d_torch.train` (port of the root
train.py; reference train.py:559-622).

The same flags, strictly parsed (an unknown flag is an error), python config
files with `_base_` inheritance through --configs, a log file under
<exps_dir>/<expname>/log, the seeds, the viewer bridge on --ip / --port
(6009 by default; --port -1 leaves it off), --detect_anomaly, the save marks
10000 and 20000, then `training(cfg)`: the four-stage curriculum, or with
--resume_from_final_stage 1 the discrete stage from --start_checkpoint.
Runs on the GPU unless `--device cpu`; without a GPU it raises.

Under torchrun (`python -m torch.distributed.run --nproc_per_node D -m
langsplat4d_torch.train ... --dist_backend nccl|gloo`, D =
`runtime.data_parallel` x `runtime.gaussian_shards`) each rank joins the
process group from the environment, takes the card of its LOCAL_RANK and
trains its share of the state (train/loop.py); rank 0 alone logs to the
file, serves the viewer and writes. `--dist_backend` is nccl by default,
gloo with `--device cpu`; ranks that share one card need gloo.
"""
import argparse
import logging
import os
import sys
import time

import torch

from langsplat4d_torch.config import parse_cli
from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.parallel.mesh import init_from_env
from langsplat4d_torch.render.__main__ import dist_backend
from langsplat4d_torch.utils import network_gui
from langsplat4d_torch.utils.logging import (add_file_sink, get_logger,
                                             safe_state)
from langsplat4d_torch.utils.profiling import enable_nan_debug


def parse_args(argv=None):
    """The command line -> (the CLI's own flags, the training Config); an
    unknown flag is an error."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", type=str, default=None,
                     help="torch device; the current CUDA device by default "
                          "(under torchrun, LOCAL_RANK's)")
    pre.add_argument("--dist_backend", type=str, default=None,
                     help="torch.distributed backend under torchrun: nccl "
                          "by default, gloo with --device cpu")
    args, rest = pre.parse_known_args(argv)
    return args, parse_cli(rest, description="Training script parameters",
                           strict=True)


def main(argv=None):
    """Returns the trained TrainState."""
    args, cfg = parse_args(argv)
    made = init_from_env(dist_backend(args))
    try:
        return _train(args, cfg)
    finally:
        if made:
            torch.distributed.destroy_process_group()


def _train(args, cfg):
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    root = (not torch.distributed.is_initialized()
            or torch.distributed.get_rank() == 0)
    logger = get_logger()
    if not cfg.model.model_path:
        cfg.model.model_path = os.path.join(cfg.runtime.exps_dir,
                                            cfg.extras.expname)
    if root:
        timestamp = time.strftime("%Y%m%d_%H%M%S")
        add_file_sink(os.path.join(cfg.runtime.exps_dir, cfg.extras.expname,
                                   "log"), f"log_{timestamp}_train.log")
    else:
        logger.setLevel(logging.WARNING)
    logger.info("Optimizing %s", cfg.model.model_path)
    safe_state(seed=cfg.extras.seed)
    if cfg.extras.port >= 0 and root:
        try:
            network_gui.init(cfg.extras.ip, cfg.extras.port)
            logger.info("GUI server listening on %s:%d", cfg.extras.ip,
                        cfg.extras.port)
        except OSError as e:
            logger.warning("GUI server unavailable (%s); training without "
                           "viewer bridge.", e)
    if cfg.extras.detect_anomaly:
        enable_nan_debug(True)
    for it in (10000, 20000):               # train.py:617-618
        if it not in cfg.extras.save_iterations:
            cfg.extras.save_iterations.append(it)

    from langsplat4d_torch.train.loop import training
    try:
        state = training(cfg, device=device)
    finally:
        network_gui.close()
    logger.info("Training complete.")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
