"""Loss and image-metric functions (port of langsplat4d/train/losses.py;
reference utils/loss_utils.py, utils/image_utils.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred, gt):
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred, gt):
    return torch.mean((pred - gt) ** 2)


def cos_loss(pred, gt, dim: int = -1, eps: float = 1e-8):
    """1 - mean cosine similarity (the reference's cos_loss uses dim=-1)."""
    num = torch.sum(pred * gt, dim=dim)
    den = torch.linalg.norm(pred, dim=dim) * torch.linalg.norm(gt, dim=dim)
    return 1.0 - torch.mean(num / torch.clamp(den, min=eps))


def psnr(img1, img2, mask=None):
    """PSNR over [C, H, W] or batched images (utils/image_utils.py:16-38)."""
    if mask is None:
        mse = torch.mean((img1 - img2) ** 2)
    else:
        diff2 = ((img1 - img2) ** 2) * mask
        mse = torch.sum(diff2) / torch.clamp(
            torch.sum(mask) * img1.shape[-3], min=1)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def _gaussian_window(window_size: int, sigma: float, device) -> torch.Tensor:
    xs = torch.arange(window_size, dtype=torch.float32, device=device)
    g = torch.exp(-((xs - window_size // 2) ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def ssim(img1, img2, window_size: int = 11):
    """SSIM with an 11x11 sigma-1.5 Gaussian window (loss_utils.py:39-69).
    img*: [C, H, W] or [B, C, H, W]; the window is applied as two separable
    depthwise convolutions with zero SAME padding."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    c = img1.shape[-3]
    w1d = _gaussian_window(window_size, 1.5, img1.device)
    kh = w1d.reshape(1, 1, window_size, 1).repeat(c, 1, 1, 1)
    kw = w1d.reshape(1, 1, 1, window_size).repeat(c, 1, 1, 1)
    pad = window_size // 2

    def blur(x):
        x = F.conv2d(x, kh, padding=(pad, 0), groups=c)
        return F.conv2d(x, kw, padding=(0, pad), groups=c)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)
