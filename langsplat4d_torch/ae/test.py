"""Autoencoder export CLI, `python -m langsplat4d_torch.ae.test` (port of
langsplat4d/ae/test.py; reference autoencoder/test.py:11-107): encodes the
full feature set, 256 rows at a time, into `language_features_dim{d}` (or
`{language_name}-{suffix}_dim{d}`) and copies the `_s.npy` segment maps
through. With `use_vae=t` the exported feature is the L2-normalised
reparameterised sample, its noise drawn from a generator seeded with
`--seed`. Runs on the GPU unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys

import numpy as np
import torch

from langsplat4d_torch.ae import model as M
from langsplat4d_torch.ae.data import load_feature_dataset
from langsplat4d_torch.core.device import fp32_matmul, resolve_device

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--encoder_dims", nargs="+", type=int,
                   default=[256, 128, 64, 32, 3])
    p.add_argument("--decoder_dims", nargs="+", type=int,
                   default=[16, 32, 64, 128, 256, 256, 512])
    p.add_argument("--hidden_dims", type=int, default=3)
    p.add_argument("--feature_dims", type=int, default=512)
    p.add_argument("--language_name", type=str, default=None)
    p.add_argument("--output_name", type=str, default=None)
    p.add_argument("--ckpt_dir", type=str, default="ckpt")
    p.add_argument("--latent_dim", type=int, default=9,
                   help="VanillaVAE latent width (reference test.py:77)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the current CUDA device by default")
    return p.parse_args(argv)


def output_dir_of(args) -> tuple:
    """(the features' directory, the export's directory)."""
    d = args.encoder_dims[-1]
    if args.language_name is None:
        return (os.path.join(args.dataset_path, "language_features"),
                os.path.join(args.dataset_path, f"language_features_dim{d}"))
    suffix = args.output_name if args.output_name else "language_features"
    return (os.path.join(args.dataset_path, args.language_name),
            os.path.join(args.dataset_path,
                         f"{args.language_name}-{suffix}_dim{d}"))


@torch.no_grad()
def main(argv=None):
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                            format="%(asctime)s | %(levelname)s | "
                                   "%(message)s")
    args = parse_args(argv)
    use_vae = os.getenv("use_vae", "f") == "t"
    device = resolve_device(args.device)
    data_dir, output_dir = output_dir_of(args)
    os.makedirs(output_dir, exist_ok=True)
    for filename in os.listdir(data_dir):
        if filename.endswith("_s.npy"):
            shutil.copy(os.path.join(data_dir, filename),
                        os.path.join(output_dir, filename))

    ckpt_path = os.path.join(args.ckpt_dir, args.model_name, "best_ckpt.pth")
    model = M.load_ckpt(ckpt_path, args.encoder_dims, args.decoder_dims,
                        args.feature_dims, device=device)
    data, data_dic = load_feature_dataset(data_dir)
    x = torch.from_numpy(data).to(device)
    gen = torch.Generator(device).manual_seed(args.seed)
    outs = []
    with fp32_matmul():
        for i in range(0, len(data), 256):
            batch = x[i:i + 256]
            if use_vae:
                mu, log_var = model.encode(batch)
                outs.append(model.reparameterize(mu, log_var, gen))
            else:
                outs.append(model.encode(batch))
    features = torch.cat(outs).cpu().numpy()

    start = 0
    for k, v in data_dic.items():
        np.save(os.path.join(output_dir, k), features[start:start + v])
        start += v
    logger.info(f"exported {len(features)} encoded features to {output_dir}")
    return output_dir


if __name__ == "__main__":
    main(sys.argv[1:])
