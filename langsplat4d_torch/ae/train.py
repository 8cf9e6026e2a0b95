"""Autoencoder training CLI, `python -m langsplat4d_torch.ae.train` (port of
langsplat4d/ae/train.py; reference autoencoder/train.py:28-185).

L2 + `cos_weight` x cosine loss (MSE + KLD with `use_vae=t`), one global Adam
step a batch (`train/optim.py adam_update`, eps 1e-8) with the BatchNorm
running stats kept from the forward, an `np.random.default_rng(seed)`
permutation per epoch with the tail batch, an eval after `eval_from_epoch`
with the best and every-10-epoch checkpoints, and the `split_dataset` env
knob for an 80/20 eval split. Checkpoints are torch state dicts in the
reference's layout (ckpt/<model_name>/best_ckpt.pth). Runs on the GPU unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

from langsplat4d_torch.ae import model as M
from langsplat4d_torch.ae.data import load_feature_dataset
from langsplat4d_torch.core.device import fp32_matmul, resolve_device
from langsplat4d_torch.core.transforms import safe_normalize
from langsplat4d_torch.train.optim import adam_init, adam_update

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--encoder_dims", nargs="+", type=int,
                   default=[256, 128, 64, 32, 3])
    p.add_argument("--decoder_dims", nargs="+", type=int,
                   default=[32, 64, 128, 256, 256, 512])
    p.add_argument("--hidden_dims", type=int, default=3)
    p.add_argument("--feature_dims", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--cos_weight", type=float, default=1e-3)
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--language_name", type=str, default=None)
    p.add_argument("--ckpt_dir", type=str, default="ckpt")
    p.add_argument("--eval_from_epoch", type=int, default=90)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--latent_dim", type=int, default=9,
                   help="VanillaVAE latent width (use_vae=t)")
    p.add_argument("--kld_weight", type=float, default=0.00025,
                   help="VanillaVAE KL weight (loss_function M_N)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the current CUDA device by default")
    return p.parse_args(argv)


def init_model(args, use_vae: bool) -> torch.nn.Module:
    """The untrained module, its weights drawn from a generator seeded with
    `args.seed`."""
    gen = torch.Generator().manual_seed(args.seed)
    if use_vae:
        return M.VanillaVAE(args.encoder_dims, args.decoder_dims,
                            args.latent_dim, args.feature_dims, generator=gen)
    return M.Autoencoder(args.encoder_dims, args.decoder_dims,
                         args.feature_dims, generator=gen)


def l2_cos(out: torch.Tensor, batch: torch.Tensor):
    """(mean squared error, 1 - mean cosine similarity)."""
    l2 = torch.mean((out - batch) ** 2)
    cos = 1.0 - torch.mean(torch.sum(out * batch, -1) / (
        torch.linalg.norm(out, dim=-1)
        * torch.clamp(torch.linalg.norm(batch, dim=-1), min=1e-8)))
    return l2, cos


def main(argv=None):
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                            format="%(asctime)s | %(levelname)s | "
                                   "%(message)s")
    args = parse_args(argv)
    use_vae = os.getenv("use_vae", "f") == "t"
    if not use_vae:
        assert args.hidden_dims == args.encoder_dims[-1]
    assert args.feature_dims == args.decoder_dims[-1]
    device = resolve_device(args.device)

    data_dir = os.path.join(args.dataset_path,
                            args.language_name or "language_features")
    out_dir = os.path.join(args.ckpt_dir, args.model_name)
    os.makedirs(out_dir, exist_ok=True)
    data, _ = load_feature_dataset(data_dir)
    rng = np.random.default_rng(args.seed)
    if os.getenv("split_dataset", "f") == "t":
        perm = rng.permutation(len(data))
        cut = int(0.8 * len(data))
        train_data, test_data = data[perm[:cut]], data[perm[cut:]]
    else:
        train_data = test_data = data
    logger.info(f"AE training on {len(train_data)} features "
                f"({args.feature_dims}->{args.hidden_dims})")
    train_dev = torch.from_numpy(np.ascontiguousarray(train_data)).to(device)
    test_dev = torch.from_numpy(np.ascontiguousarray(test_data)).to(device)

    model = init_model(args, use_vae).to(device)
    params = dict(model.named_parameters())
    opt = adam_init(params)
    lrs = dict.fromkeys(params, args.lr)
    trainable = dict.fromkeys(params, True)
    eps_gen = torch.Generator(device).manual_seed(args.seed + 1)

    def train_batch(batch):
        model.train()
        if use_vae:
            recon, mu, log_var = model(batch, generator=eps_gen)
            loss, _, _ = M.vae_loss(recon, batch, mu, log_var,
                                    args.kld_weight)
        else:
            l2, cos = l2_cos(model(batch), batch)
            loss = l2 + cos * args.cos_weight
        grads = torch.autograd.grad(loss, list(params.values()))
        adam_update(params, dict(zip(params, grads)), opt, lrs, trainable,
                    eps=1e-8)

    @torch.no_grad()
    def eval_batch(batch):
        model.eval()
        if use_vae:
            # deterministic eval: decode the normalized mean latent
            mu, _ = model.encode(batch)
            out = model.decode(safe_normalize(mu))
        else:
            out = model(batch)
        l2, cos = l2_cos(out, batch)
        return l2 + cos

    bs = args.batch_size
    best_eval, best_epoch = 100.0, 0
    n = len(train_data)
    with fp32_matmul():
        for epoch in range(args.num_epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(device)
            for i in range(0, n - bs + 1, bs):
                train_batch(train_dev[perm[i:i + bs]])
            tail = n % bs
            if tail:
                train_batch(train_dev[perm[n - tail:]])

            if epoch > args.eval_from_epoch:
                tot = torch.zeros((), dtype=torch.float64, device=device)
                m = len(test_data)
                for i in range(0, m, 256):
                    batch = test_dev[i:i + 256]
                    tot += eval_batch(batch).double() * len(batch)
                eval_loss = float(tot) / m
                logger.info(f"epoch {epoch} eval_loss:{eval_loss:.8f}")
                if eval_loss < best_eval:
                    best_eval, best_epoch = eval_loss, epoch
                    M.save_ckpt(os.path.join(out_dir, "best_ckpt.pth"), model)
                if epoch % 10 == 0:
                    M.save_ckpt(os.path.join(out_dir, f"{epoch}_ckpt.pth"),
                                model)
    if not os.path.exists(os.path.join(out_dir, "best_ckpt.pth")):
        M.save_ckpt(os.path.join(out_dir, "best_ckpt.pth"), model)
    logger.info(f"best_epoch: {best_epoch} best_loss: {best_eval:.8f}")
    return best_eval


if __name__ == "__main__":
    main(sys.argv[1:])
