"""Training CLI, `python -m langsplat4d_torch.train` (port of the root
train.py; reference train.py:559-622).

The same flags, strictly parsed (an unknown flag is an error), python config
files with `_base_` inheritance through --configs, a log file under
<exps_dir>/<expname>/log, the seeds, the viewer bridge on --ip / --port
(6009 by default; --port -1 leaves it off), --detect_anomaly, the save marks
10000 and 20000, then `training(cfg)`: the four-stage curriculum, or with
--resume_from_final_stage 1 the discrete stage from --start_checkpoint.
Runs on the GPU unless `--device cpu`; without a GPU it raises.
"""
import argparse
import os
import sys
import time

from langsplat4d_torch.config import parse_cli
from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.utils import network_gui
from langsplat4d_torch.utils.logging import (add_file_sink, get_logger,
                                             safe_state)
from langsplat4d_torch.utils.profiling import enable_nan_debug


def main(argv=None):
    """Returns the trained TrainState."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", type=str, default=None,
                     help="torch device; the current CUDA device by default")
    args, rest = pre.parse_known_args(argv)
    cfg = parse_cli(rest, description="Training script parameters",
                    strict=True)
    device = resolve_device(args.device)
    logger = get_logger()
    if not cfg.model.model_path:
        cfg.model.model_path = os.path.join(cfg.runtime.exps_dir,
                                            cfg.extras.expname)
    timestamp = time.strftime("%Y%m%d_%H%M%S")
    add_file_sink(os.path.join(cfg.runtime.exps_dir, cfg.extras.expname,
                               "log"), f"log_{timestamp}_train.log")
    logger.info("Optimizing %s", cfg.model.model_path)
    safe_state(seed=cfg.extras.seed)
    if cfg.extras.port >= 0:
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
