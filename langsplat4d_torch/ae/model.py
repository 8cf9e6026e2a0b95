"""Language-feature autoencoder (512->3 CLIP / 4096->6 video compressor);
port of langsplat4d/ae/model.py (reference autoencoder/model.py:5-246).

`Autoencoder`: the encoder is Linear -> [BatchNorm1d, ReLU, Linear]*, the
decoder Linear -> [ReLU, Linear]*, and the output is L2-normalised after
encode and after decode. `VanillaVAE` (the `use_vae` alternative): the same
encoder with LeakyReLU(0.01), `fc_mu` / `fc_var` heads, and a decoder with
LeakyReLU. The modules' state dicts have the reference's keys (encoder
Linear i at 3i, its BatchNorm at 3i-2; decoder Linear i at 2i), so
`best_ckpt.pth` files interchange with the reference and with the JAX
package. BatchNorm1d in training mode normalises with the biased batch
variance and keeps the unbiased one in its running stats (momentum 0.1, eps
1e-5), as the JAX package's `_batchnorm` does; a batch of one row, which
`nn.BatchNorm1d` refuses in training mode, normalises to 0 as there.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.core.transforms import safe_normalize
from langsplat4d_torch.field.nets import init_linear_

LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU default


class BatchNorm1d(nn.BatchNorm1d):
    """`nn.BatchNorm1d` with its state-dict keys, which in training mode
    also takes a batch of one row, as the JAX package's `_batchnorm` does
    (langsplat4d/ae/model.py:45-58): the biased variance is 0, so the output
    is (x - mean) * rsqrt(0 + eps) = 0 before the affine, and the running
    variance takes var * n / max(n - 1, 1) = 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and x.shape[0] == 1):
            return super().forward(x)
        mean = x.mean(0)
        var = x.var(0, unbiased=False)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_mean.mul_(1 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


def _encoder(dims: Sequence[int], feature_dim: int, act, generator):
    layers = []
    prev = feature_dim
    for i, d in enumerate(dims):
        if i > 0:
            layers += [BatchNorm1d(prev), act()]
        layers.append(init_linear_(nn.Linear(prev, d), generator))
        prev = d
    return nn.ModuleList(layers)


def _decoder(dims: Sequence[int], in_dim: int, act, generator):
    layers = []
    prev = in_dim
    for i, d in enumerate(dims):
        if i > 0:
            layers.append(act())
        layers.append(init_linear_(nn.Linear(prev, d), generator))
        prev = d
    return nn.ModuleList(layers)


def _run(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for m in layers:
        x = m(x)
    return x


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator()


class Autoencoder(nn.Module):
    def __init__(self, encoder_dims: Sequence[int],
                 decoder_dims: Sequence[int], feature_dim: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _generator(generator)
        self.encoder = _encoder(encoder_dims, feature_dim, nn.ReLU, gen)
        self.decoder = _decoder(decoder_dims, encoder_dims[-1], nn.ReLU, gen)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return safe_normalize(_run(self.encoder, x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return safe_normalize(_run(self.decoder, z))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


class VanillaVAE(nn.Module):
    def __init__(self, encoder_dims: Sequence[int],
                 decoder_dims: Sequence[int], latent_dim: int = 9,
                 feature_dim: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _generator(generator)
        act = lambda: nn.LeakyReLU(LEAKY_SLOPE)  # noqa: E731
        self.encoder = _encoder(encoder_dims, feature_dim, act, gen)
        self.fc_mu = init_linear_(nn.Linear(encoder_dims[-1], latent_dim), gen)
        self.fc_var = init_linear_(nn.Linear(encoder_dims[-1], latent_dim),
                                   gen)
        self.decoder = _decoder(decoder_dims, latent_dim, act, gen)

    def encode(self, x: torch.Tensor):
        """-> (mu, log_var)."""
        h = _run(self.encoder, x)
        return self.fc_mu(h), self.fc_var(h)

    @staticmethod
    def reparameterize(mu: torch.Tensor, log_var: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z = mu + eps * exp(0.5 log_var), L2-normalised (reference
        model.py:173-185); eps ~ N(0, 1) from `generator` unless given."""
        std = torch.exp(0.5 * log_var)
        if eps is None:
            eps = torch.randn(std.shape, generator=generator,
                              device=std.device, dtype=std.dtype)
        return safe_normalize(eps * std + mu)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return safe_normalize(_run(self.decoder, z))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """-> (recon, mu, log_var) (the reference returns [decode(z), input,
        mu, log_var], model.py:187-190)."""
        mu, log_var = self.encode(x)
        z = self.reparameterize(mu, log_var, generator, eps)
        return self.decode(z), mu, log_var


def vae_loss(recon, x, mu, log_var, kld_weight: float):
    """MSE + kld_weight * KL(N(mu, sigma) || N(0, 1)) (loss_function,
    model.py:198-219) -> (loss, recons_loss, kld)."""
    recons = torch.mean((recon - x) ** 2)
    kld = torch.mean(-0.5 * torch.sum(1 + log_var - mu ** 2
                                      - torch.exp(log_var), dim=1))
    return recons + kld_weight * kld, recons, kld


def save_ckpt(path: str, model: nn.Module) -> None:
    """The module's state dict, on the CPU, in the reference's layout."""
    torch.save({k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}, path)


def load_ckpt(path: str, encoder_dims: Sequence[int],
              decoder_dims: Sequence[int], feature_dim: int = 512,
              device=None) -> nn.Module:
    """A reference-layout `best_ckpt.pth` -> Autoencoder, or VanillaVAE where
    the file has `fc_mu` keys, loaded with strict=True, in eval mode, on
    `device` (None: the current CUDA device, an error where there is none).
    The input width is the checkpoint's (the JAX package's loaders read it
    from the weights too); `feature_dim` is accepted for their signature."""
    del feature_dim
    device = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    width = sd["encoder.0.weight"].shape[1]
    if any(k.startswith("fc_mu") for k in sd):
        model = VanillaVAE(encoder_dims, decoder_dims,
                           latent_dim=sd["fc_mu.weight"].shape[0],
                           feature_dim=width)
    else:
        model = Autoencoder(encoder_dims, decoder_dims, feature_dim=width)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()
